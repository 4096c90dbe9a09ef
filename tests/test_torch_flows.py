"""PyTorch port: the SMC preconditioner's normalizing flow against the JAX
package, on carried weights.  CPU, float64."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gpbayestools_hic_tpu.samplers import flows as jfl
from gpbayestools_hic_tpu_torch.samplers.flows import Flow, FlowConfig, fit_flow, flow_from_jax

CONFIGS = {
    "rqs": FlowConfig(n_layers=4, hidden=16),
    "affine": FlowConfig(n_layers=4, hidden=16, coupling="affine"),
}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: these tensors are tiny, and the suite runs in
    parallel worker processes, where multi-threaded torch ops on every
    worker oversubscribe the cores many times over."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _trained_like_params(cfg, ndim=3, seed=0):
    """JAX flow parameters away from the identity: init_flow, then every
    weight perturbed by 0.05 standard normals (the zero last layers too)
    and a non-trivial pre-layer.  Larger perturbations give splines steep
    enough that the inverse amplifies rounding: at 0.3 JAX's own round
    trip misses by 6e-3."""
    params = jfl.init_flow(jax.random.PRNGKey(seed), ndim, cfg, jnp.float64)
    rng = np.random.default_rng(seed + 1)
    host = jax.tree.map(lambda a: np.asarray(a) + 0.05 * rng.standard_normal(np.shape(a)), params)
    return jax.tree.map(jnp.asarray, host)


def _data(n=64, ndim=3, seed=2):
    rng = np.random.default_rng(seed)
    return rng.normal(size=(n, ndim)) @ np.array([[1.0, 0.4, 0.0], [0.0, 0.8, 0.3],
                                                  [0.0, 0.0, 0.6]])[:ndim, :ndim] * 2 + 0.5


@pytest.mark.parametrize("coupling", ["rqs", "affine"])
def test_carried_weights_give_jax_densities(coupling):
    """flow_from_jax: forward, inverse (both with their log-determinants)
    and the log density equal JAX's to 1e-10 (float64, same arithmetic up
    to rounding order), with points inside and outside the spline box."""
    cfg = CONFIGS[coupling]
    params = _trained_like_params(cfg)
    flow = flow_from_jax(jax.tree.map(np.asarray, params), cfg)
    u = _data()
    u[0] = [12.0, -9.0, 0.5]  # outside the spline support in two coordinates
    t = torch.tensor(u)
    with torch.no_grad():
        z, ld = flow(t)
        u2, ld_i = flow.inverse(z)
        lq = flow.logprob(t)
    jz, jld = jfl.flow_forward(params, jnp.asarray(u), cfg)
    ju, jld_i = jfl.flow_inverse(params, jz, cfg)
    for got, want in ((z, jz), (ld, jld), (u2, ju), (ld_i, jld_i),
                      (lq, jfl.flow_logprob(params, jnp.asarray(u), cfg))):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-10, atol=1e-10)


@pytest.mark.parametrize("coupling", ["rqs", "affine"])
def test_round_trip(coupling):
    """inverse(forward(u)) = u and the log-determinants cancel, to 1e-8
    (the JAX test's tolerance; the spline inverse solves a quadratic)."""
    cfg = CONFIGS[coupling]
    flow = flow_from_jax(jax.tree.map(np.asarray, _trained_like_params(cfg, seed=5)), cfg)
    u = torch.tensor(_data(seed=6))
    with torch.no_grad():
        z, ld = flow(u)
        u2, ld_i = flow.inverse(z)
    np.testing.assert_allclose(u2.numpy(), u.numpy(), atol=1e-8)
    np.testing.assert_allclose((ld + ld_i).numpy(), 0.0, atol=1e-8)


@pytest.mark.parametrize("coupling", ["rqs", "affine"])
def test_init_is_jax_init_and_identity(coupling):
    """Seeded with the JAX key's data, the module's initial weights are
    init_flow's; at initialization the flow is the identity (exactly for
    the affine coupling, to 1e-12 for the spline, whose identity goes
    through its bin arithmetic)."""
    cfg = CONFIGS[coupling]
    key = jax.random.PRNGKey(3)
    jp = jfl.init_flow(key, 3, cfg, jnp.float64)
    flow = Flow(3, cfg, seed=np.asarray(jax.random.key_data(key)).astype(np.uint32).tolist(),
                dtype=torch.float64)
    for layer, jl in zip(flow.layers, jp["layers"]):
        flat = [a for wb in jl["mlp"] for a in (wb["w"], wb["b"])]
        for p, a in zip(layer, flat):
            np.testing.assert_array_equal(p.detach().numpy(), np.asarray(a))
    u = torch.tensor(_data())
    with torch.no_grad():
        z, ld = flow(u)
    np.testing.assert_allclose(z.numpy(), u.numpy(), rtol=0, atol=1e-12)
    np.testing.assert_allclose(ld.numpy(), 0.0, rtol=0, atol=1e-12)


@pytest.mark.parametrize("coupling", ["rqs", "affine"])
def test_adamw_steps_match_optax(coupling):
    """25 AdamW steps from the same carried weights and weighted data: every
    parameter and the last loss equal optax.adamw's (JAX fit_flow with no
    patience) to 1e-8; the whitening pre-layer is a buffer set from the
    weighted moments and no step moves it."""
    cfg = CONFIGS[coupling]
    params = _trained_like_params(cfg, seed=7)
    u = _data(n=96, seed=8)
    w = np.random.default_rng(9).uniform(0.2, 1.0, size=u.shape[0])
    jp, jloss = jfl.fit_flow(params, jnp.asarray(u), jnp.asarray(w), jax.random.PRNGKey(0),
                             config=cfg, steps=25, lr=3e-3)
    flow = flow_from_jax(jax.tree.map(np.asarray, params), cfg)
    loss = fit_flow(flow, torch.tensor(u), torch.tensor(w), 25, lr=3e-3, return_best=False)
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-8)
    for layer, jl in zip(flow.layers, jp["layers"]):
        flat = [a for wb in jl["mlp"] for a in (wb["w"], wb["b"])]
        for p, a in zip(layer, flat):
            np.testing.assert_allclose(p.detach().numpy(), np.asarray(a), rtol=1e-8, atol=1e-8)
    wn = w / w.sum()
    mean = wn @ u
    np.testing.assert_allclose(flow.pre_mean.numpy(), mean, rtol=1e-12)
    np.testing.assert_allclose(flow.pre_log_scale.numpy(),
                               0.5 * np.log(wn @ (u - mean) ** 2 + 1e-12), rtol=1e-12)
    np.testing.assert_allclose(flow.pre_mean.numpy(), np.asarray(jp["pre_mean"]), rtol=1e-12)
    names = {n for n, _ in flow.named_parameters()}
    assert not any("pre_" in n or "mask" in n for n in names)


def test_patience_returns_best_and_sparse_reads_agree():
    """With patience, the fit returns the best parameters seen and their
    loss (JAX fit_flow_dynamic's rule, parameters to 1e-8); reading the
    stop flag every 8 steps returns exactly the parameters of reading it
    every step."""
    cfg = CONFIGS["affine"]
    params = jfl.init_flow(jax.random.PRNGKey(0), 2, cfg, jnp.float64)
    rng = np.random.default_rng(2)
    u = rng.normal(size=(256, 2)) @ np.array([[1.0, 0.6], [0.0, 0.8]])
    w = np.ones(len(u))
    jp, jloss = jfl.fit_flow(params, jnp.asarray(u), jnp.asarray(w), jax.random.PRNGKey(1),
                             config=cfg, steps=300, patience=20)
    fits = []
    for every in (1, 8):
        flow = flow_from_jax(jax.tree.map(np.asarray, params), cfg)
        stats = {}
        loss = fit_flow(flow, torch.tensor(u), torch.tensor(w), 300, patience=20,
                        check_every=every, stats=stats)
        with torch.no_grad():
            fresh = float(-flow.logprob(torch.tensor(u)).mean())
        assert abs(fresh - float(loss)) < 1e-10 * max(1.0, abs(fresh))
        fits.append((float(loss), [p.detach().numpy().copy() for p in flow.parameters()],
                     stats["steps"]))
    assert fits[0][2] < 300  # patience stopped the fit
    assert fits[0][0] == fits[1][0]
    for a, b in zip(fits[0][1], fits[1][1]):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_allclose(fits[0][0], float(jloss), rtol=1e-8)
    flat = [a for jl in jp["layers"] for wb in jl["mlp"] for a in (wb["w"], wb["b"])]
    for p, a in zip(fits[0][1], flat):
        np.testing.assert_allclose(p, np.asarray(a), rtol=1e-8, atol=1e-8)


def test_zero_step_budget_and_unknown_coupling_refused():
    flow = Flow(2, CONFIGS["affine"], dtype=torch.float64)
    u = torch.zeros((4, 2), dtype=torch.float64)
    with pytest.raises(ValueError, match="steps"):
        fit_flow(flow, u, torch.ones(4, dtype=torch.float64), 0)
    with pytest.raises(ValueError, match="coupling"):
        Flow(2, FlowConfig(coupling="spline"))
