"""PyTorch port: walker sharding (``parallel/mesh.py`` and the ``devices=`` /
``mesh=`` knobs of every sampler) against the JAX package.

CPU, float64.  The mesh functions give the JAX functions' decisions and
messages on the 8-device CPU mesh that ``tests/conftest.py`` provides (the
port's CUDA device count monkeypatched to the same 8).  The port's sharded
posterior on ``WalkerMesh([cpu] * 8)`` equals JAX's sharded posterior on
its mesh over the same saved emulators; sharded runs through the public
front-ends equal unsharded ones at the JAX tests' tolerances
(``tests/test_parallel.py``).
"""

import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gpbayestools_hic_tpu import parallel as jpar
from gpbayestools_hic_tpu.models import Emulator as JEmulator
from gpbayestools_hic_tpu.samplers import Chain as JChain
from gpbayestools_hic_tpu_torch.parallel import mesh as ppar
from gpbayestools_hic_tpu_torch.parallel import WalkerMesh
from gpbayestools_hic_tpu_torch.samplers import Chain
from gpbayestools_hic_tpu_torch.samplers import smc as psmc
from gpbayestools_hic_tpu_torch.samplers.flows import FlowConfig

F64 = dict(device="cpu", dtype=torch.float64)
CPU = torch.device("cpu")
MESH8 = WalkerMesh([CPU] * 8)
# the public-API runs shard over 4: each shard adds its own dispatch, and 4
# keep the file quick while splitting every half ensemble and warmup subset
MESH4 = WalkerMesh([CPU] * 4)
CFG = FlowConfig(n_layers=2, hidden=16)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the tensors are tiny and the suite runs in
    parallel worker processes."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def eight_cards(monkeypatch):
    """The port's CUDA device count set to the JAX CPU mesh's 8."""
    assert jax.device_count() == 8
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 8)


def _outcome(fn, *args):
    try:
        return ("ok", fn(*args))
    except ValueError as e:
        return ("raises", str(e))


# ------------------------------------------------------------- mesh functions


@pytest.mark.parametrize("n", [None, 1, 3, 8, 9, 12])
def test_make_mesh_matches_jax(eight_cards, n):
    """Accepts up to the device count (all of them for None), raises with
    the JAX message past it, never returns a smaller mesh."""
    want, got = _outcome(jpar.make_mesh, n), _outcome(ppar.make_mesh, n)
    assert got[0] == want[0]
    if want[0] == "raises":
        assert got[1] == want[1]
    else:
        assert got[1].size == want[1].devices.size
        assert got[1].devices == tuple(torch.device("cuda", i) for i in range(got[1].size))


@pytest.mark.parametrize("devices", [None, 0, 1, -1, 2, 8, 9, -2, -5])
def test_resolve_mesh_matches_jax(eight_cards, devices):
    """None/0/1: no sharding; -1: every device; N: the first N; below -1
    and past the device count: the JAX messages; a given mesh wins."""
    want, got = _outcome(jpar.resolve_mesh, devices), _outcome(ppar.resolve_mesh, devices)
    assert got[0] == want[0]
    if want[0] == "raises":
        assert got[1] == want[1]
    elif want[1] is None:
        assert got[1] is None
    else:
        assert got[1].size == want[1].devices.size
    jm = jpar.make_mesh(2)
    assert jpar.resolve_mesh(devices, jm) is jm
    assert ppar.resolve_mesh(devices, MESH8) is MESH8


@pytest.mark.parametrize("n,what", [(16, "walkers"), (12, "walkers"), (7, "walkers"),
                                    (66, "chains (ntemps + nwalkers)"),
                                    (64, "n_prior particles")])
def test_check_divisible_matches_jax(n, what):
    want = _outcome(jpar.check_divisible, jpar.make_mesh(8), n, what)
    got = _outcome(ppar.check_divisible, MESH8, n, what)
    assert got == want


def test_shard_batch_and_replicate():
    """tensor_split shards (sizes differ by at most one, so the half
    ensembles need not divide); a repeated device shares one replica."""
    x = torch.arange(21.0).reshape(7, 3)
    chunks = ppar.shard_batch(WalkerMesh([CPU] * 3), x)
    assert [c.shape[0] for c in chunks] == [3, 2, 2]
    torch.testing.assert_close(torch.cat(chunks), x, rtol=0, atol=0)
    tree = {"a": torch.ones(2), "b": (torch.zeros(1), 3)}
    reps = ppar.replicate(MESH8, tree)
    assert len(reps) == 8 and all(r is reps[0] for r in reps)
    assert reps[0]["a"] is tree["a"] and reps[0]["b"][1] == 3


# --------------------------------------------------------------- the problem


@pytest.fixture(scope="module")
def problem(tmp_path_factory):
    """Two JAX-trained emulators (3 parameters, blocks of 4 and 3
    observables, 3 PCs) saved once; a JAX chain over them and a factory of
    port chains loading the saves, each with its own chain file."""
    tmp = tmp_path_factory.mktemp("mesh")
    rng = np.random.default_rng(42)
    ndim, nev = 3, 35
    design = rng.uniform(0, 1, size=(nev, ndim))
    par = tmp / "pars.txt"
    par.write_text("".join(f"p{i}: $p_{i}$, 0.0, 1.0\n" for i in range(ndim)))
    truth = np.array([0.4, 0.6, 0.5])
    emus, saves, exp_obs = [], [], []
    for b, nobs in enumerate([4, 3]):
        freqs = rng.uniform(1, 2.5, size=(ndim, nobs))
        base = 2.0 + np.sin(design @ freqs) + (design**2) @ freqs * 0.2
        pkl = tmp / f"train{b}.pkl"
        with open(pkl, "wb") as f:
            pickle.dump({str(i): {"parameter": design[i],
                                  "obs": np.stack([base[i], 0.01 * np.abs(base[i])])}
                         for i in range(nev)}, f)
        e = JEmulator(str(pkl), str(par), npc=3, gp_maxiter=5)
        e.trainEmulatorAutoMask()
        e.save(str(tmp / f"emu{b}.pkl"))
        emus.append(e)
        saves.append(str(tmp / f"emu{b}.pkl"))
        exp_obs.append(2.0 + np.sin(truth @ freqs) + (truth**2) @ freqs * 0.2)
    exp_mean = np.concatenate(exp_obs)
    exp_pkl = tmp / "exp.pkl"
    with open(exp_pkl, "wb") as f:
        pickle.dump({"0": {"obs": np.stack([exp_mean, 0.05 * np.abs(exp_mean)])}}, f)
    jc = JChain(mcmc_path=str(tmp / "j" / "chain.pkl"), expdata_path=str(exp_pkl),
                model_parafile=str(par))
    jc.loadEmulator(emus)

    def make(tag):
        c = Chain(mcmc_path=str(tmp / tag / "chain.pkl"), expdata_path=str(exp_pkl),
                  model_parafile=str(par), **F64)
        c.loadEmulator(saves)
        return c

    return jc, make


def _points(n_in=21, seed=0):
    rng = np.random.default_rng(seed)
    outside = np.array([[1.2, 0.5, 0.5], [0.5, -0.1, 0.5], [0.3, 0.3, 1.0]])
    return np.concatenate([rng.uniform(0.05, 0.95, size=(n_in, 3)), outside])


@pytest.mark.parametrize("mode", ["auto", "generic", "stitched"])
def test_sharded_posterior_matches_jax_sharded(problem, mode):
    """The port's sharded posterior on WalkerMesh([cpu] * 8) equals JAX's
    sharded_log_prob on its 8-device mesh at 1e-10 (24 walkers, 3 outside
    the box: -inf in both), and the port's unsharded posterior exactly
    but for float reassociation (1e-12); its value-and-gradient twin
    equals JAX's gradient at 1e-9."""
    jc, make = problem
    pc = make(f"post_{mode}")
    pc.likelihood_mode = mode
    jc.likelihood_mode = mode
    try:
        X = _points()
        jfn, jstate = jc.posterior_with_state()
        jmesh = jpar.make_mesh(8)
        want = np.asarray(jpar.sharded_log_prob(jfn, jmesh, state=jstate)(
            jpar.shard_batch(jmesh, jnp.asarray(X))))
        jg = np.asarray(jax.grad(lambda q: jnp.sum(jfn(jstate, q)))(jnp.asarray(X[:-3])))
    finally:
        jc.likelihood_mode = "auto"
    fn, state = pc.posterior_with_state()
    sharded = ppar.sharded_log_prob(fn, MESH8, state)
    x = torch.tensor(X)
    with torch.no_grad():
        got = sharded(x).numpy()
        plain = fn(state, x).numpy()
    assert np.all(np.isneginf(got[-3:])) and np.all(np.isneginf(want[-3:]))
    np.testing.assert_allclose(got[:-3], want[:-3], rtol=1e-10)
    np.testing.assert_allclose(got[:-3], plain[:-3], rtol=1e-12)
    val, g = sharded.value_and_grad(x[:-3])
    np.testing.assert_allclose(val.numpy(), got[:-3], rtol=1e-12)
    np.testing.assert_allclose(g.numpy(), jg, rtol=1e-9, atol=1e-9 * np.abs(jg).max())


def _tensors(obj):
    if torch.is_tensor(obj):
        yield obj
    elif isinstance(obj, dict):
        for v in obj.values():
            yield from _tensors(v)
    elif isinstance(obj, (list, tuple)):
        for v in obj:
            yield from _tensors(v)


def test_replica_on_emulator_copies(problem):
    """A device other than the chain's gets a posterior over emulator
    copies (Emulator.to): every tensor of the copy on the new device (the
    meta device shows none stays behind), the original untouched, the same
    values; the chain's own device gets the chain's own function."""
    _, make = problem
    pc = make("replica")
    fn, state = pc.posterior_with_state()
    assert fn.replica(CPU) is fn
    e = pc.emuList[0]
    meta = e.to("meta")
    moved = list(_tensors(list(vars(meta).values())))
    assert meta.device == torch.device("meta") and len(moved) >= 10
    assert all(t.device.type == "meta" for t in moved)
    assert all(t.device == CPU for t in _tensors(list(vars(e).values())))
    assert e.to(CPU).gp_state is not e.gp_state
    other = pc._posterior_fns_on(CPU)["log_posterior"]
    x = torch.tensor(_points())
    with torch.no_grad():
        np.testing.assert_array_equal(other(state, x).numpy(), fn(state, x).numpy())


def test_every_shard_runs_in_its_own_scope():
    """Each non-empty shard runs its own function on its own chunk, in
    order; a batch smaller than the mesh runs only the shards it fills."""
    seen = []

    def shard_fn(k):
        def fn(x):
            seen.append((k, x.shape[0]))
            return x.sum(1)
        return fn

    sm = ppar.shard_map(WalkerMesh([CPU] * 4), [shard_fn(k) for k in range(4)])
    out = sm(torch.arange(18.0).reshape(9, 2))
    torch.testing.assert_close(out, torch.arange(18.0).reshape(9, 2).sum(1), rtol=0, atol=0)
    assert seen == [(0, 3), (1, 2), (2, 2), (3, 2)]
    seen.clear()
    assert sm(torch.ones(2, 2)).shape == (2,) and seen == [(0, 1), (1, 1)]


@pytest.mark.parametrize("bounded", [True, False])
def test_sharded_hmc_value_and_grad_is_bit_equal(bounded):
    """HMC over a mesh shards only the posterior's value and gradient in x;
    the u -> x transform, its logit Jacobian and the chain rule back to u
    run over the whole batch, so with a posterior whose arithmetic is
    per walker the sharded u-space value and gradient equal the unsharded
    ones bit for bit (a batch of 37 over 4 uneven shards)."""
    from gpbayestools_hic_tpu_torch.samplers import hmc as phmc

    rng = np.random.default_rng(3)
    state = {"mu": torch.tensor([0.2, 0.7, 0.4], dtype=torch.float64),
             "prec": torch.tensor([3.0, 40.0, 9.0], dtype=torch.float64)}

    def log_prob(s, x):
        return -0.5 * (s["prec"] * (x - s["mu"]) ** 2).sum(-1) + torch.sin(5 * x).sum(-1)

    a = rng.normal(size=(3, 3))
    tf = {"chol": torch.as_tensor(np.linalg.cholesky(a @ a.T + np.eye(3))),
          "mu": torch.as_tensor(rng.normal(size=3)),
          "lo": torch.zeros(3, dtype=torch.float64),
          "width": torch.tensor([1.0, 2.0, 0.5], dtype=torch.float64)}
    u = torch.as_tensor(rng.normal(size=(37, 3)))
    plain = phmc.make_value_and_grad(log_prob, state, tf, bounded)(u)
    sharded = ppar.sharded_log_prob(log_prob, MESH4, state)
    shard = phmc.make_sharded_value_and_grad(sharded.value_and_grad, tf, bounded)(u)
    for p, q in zip(plain, shard):
        torch.testing.assert_close(q, p, rtol=0, atol=0)


# -------------------------------------------- sharded == unsharded, public API


def test_run_ensemble_mesh_matches_single():
    """run_ensemble(mesh=) == run_ensemble() (the JAX test's 5 stretch
    steps, rtol 1e-6): the half ensembles of 16 split 2 a shard over 8,
    the state replicated, the draws on the walkers' device."""
    from gpbayestools_hic_tpu_torch.samplers.ensemble import run_ensemble

    state = {"mu": torch.tensor([0.2, 0.8, 0.5], dtype=torch.float64)}

    def log_prob(s, x):
        return -0.5 * ((x - s["mu"]) ** 2).sum(-1)

    x0 = torch.as_tensor(np.random.default_rng(1).uniform(size=(32, 3)))
    plain = run_ensemble(log_prob, x0, 5, 2, state=state)
    shard = run_ensemble(log_prob, x0, 5, 2, state=state, mesh=MESH8)
    for a, b in ((plain.chain, shard.chain), (plain.final_state, shard.final_state),
                 (plain.log_prob, shard.log_prob)):
        np.testing.assert_allclose(b.numpy(), a.numpy(), rtol=1e-6)


def test_run_mcmc_mesh_matches_single(problem):
    """Chain.run_mcmc(mesh=) == run_mcmc() from a resumed chain (rtol 1e-6,
    as the JAX test): the burn-in's top-lnprob dedup compares
    log-posteriors by exact equality, which a reassociation can flip."""
    _, make = problem
    kw = dict(nsteps=8, nburnsteps=4, nwalkers=16, nthin=2, seed=3,
              skip_initial_state_check=True)
    chains = {}
    for tag, extra in (("ens_plain", {}), ("ens_shard", {"mesh": MESH4})):
        c = make(tag)
        with open(c.mcmc_path, "wb") as f:
            pickle.dump({"chain": c.random_pos(16, seed=7)[:, None, :]}, f)
        c.run_mcmc(**kw, **extra)
        chains[tag] = np.asarray(c.chain)
    assert chains["ens_shard"].shape == (16, 5, 3)
    np.testing.assert_allclose(chains["ens_shard"], chains["ens_plain"], rtol=1e-6, atol=1e-9)
    c = make("ens_bad")
    with pytest.raises(ValueError, match="walkers count 10 is not divisible"):
        c.run_mcmc(nsteps=2, nburnsteps=2, nwalkers=10, mesh=MESH4)


@pytest.mark.parametrize("scheme,persist", [("mh", 0.0), ("windowed", 0.0), ("windowed", 0.7)])
def test_run_hmc_mesh_matches_single(problem, scheme, persist):
    """Chain.run_MCMC_HMC(mesh=) == unsharded at rtol 1e-6 (the JAX
    tests), endpoint MH and windowed with and without persistent
    momentum: every draw stays on the chain's device."""
    _, make = problem
    kw = dict(nsteps=6, nwalkers=16, nburnsteps=4, n_leapfrog=3, seed=5, scheme=scheme,
              persist=persist)
    if scheme == "windowed":
        kw["window"] = 2
    out = {}
    for tag, extra in (("plain", {}), ("shard", {"mesh": MESH4})):
        c = make(f"hmc_{scheme}{persist}_{tag}")
        c.run_MCMC_HMC(**kw, **extra)
        out[tag] = np.asarray(c.chain)
    np.testing.assert_allclose(out["shard"], out["plain"], rtol=1e-6, atol=1e-9)


def test_run_hmc_warmup_walkers_over_a_mesh(problem, monkeypatch):
    """warmup_walkers="auto" takes 256 where it divides over the mesh and
    the full batch where it does not (JAX chain.py); an explicit subset
    must divide; the tiled-up run completes."""
    from gpbayestools_hic_tpu_torch.samplers import hmc as phmc

    _, make = problem
    seen = []
    real = phmc.run_hmc

    def spy(*a, **kw):
        seen.append(kw["warmup_walkers"])
        return real(*a, **{**kw, "warmup": 2, "n_leapfrog": 1})

    monkeypatch.setattr(phmc, "run_hmc", spy)
    c = make("hmc_ww")
    c.run_MCMC_HMC(nsteps=1, nwalkers=264, mesh=WalkerMesh([CPU] * 3))
    c.run_MCMC_HMC(nsteps=1, nwalkers=264, mesh=WalkerMesh([CPU] * 4))
    assert seen == [None, 256]
    monkeypatch.setattr(phmc, "run_hmc", real)
    c.run_MCMC_HMC(nsteps=4, nwalkers=16, nburnsteps=4, n_leapfrog=2, seed=5,
                   mesh=MESH4, warmup_walkers=8)
    arr = np.asarray(c.chain)
    assert arr.shape == (16, 4, 3) and np.isfinite(arr).all()
    with pytest.raises(ValueError, match="divisible"):
        c.run_MCMC_HMC(nsteps=4, nwalkers=16, nburnsteps=4, n_leapfrog=2, seed=5,
                       mesh=MESH4, warmup_walkers=6)


@pytest.mark.parametrize("use_gradients", [False, True])
def test_run_ptlmc_mesh_matches_single(problem, use_gradients):
    """Chain.run_MCMC_PTLMC(mesh=) == unsharded at rtol 1e-7 (the JAX
    test), without and with the Langevin drift (each shard's gradient on
    its own device); a count that does not divide is refused."""
    _, make = problem
    kw = dict(nsteps=4, nwalkers=8, ntemps=8, maxtemp=20.0, nstartparameters=64, seed=2,
              use_gradients=use_gradients)
    out = {}
    for tag, extra in (("plain", {}), ("shard", {"mesh": MESH4})):
        c = make(f"pt{use_gradients}_{tag}")
        c.run_MCMC_PTLMC(**kw, **extra)
        out[tag] = np.asarray(c.chain)
    np.testing.assert_allclose(out["shard"], out["plain"], rtol=1e-7, atol=1e-10)
    with pytest.raises(ValueError, match=r"chains \(ntemps \+ nwalkers\) count 14"):
        make("pt_bad").run_MCMC_PTLMC(nsteps=2, nwalkers=8, ntemps=6, mesh=MESH4)


def test_smc_iteration_mesh_matches_single(problem):
    """One _smc_iteration (flow fit, dof, adaptive tPCN MCMC) with the
    likelihood sharded equals the unsharded one at 1e-12: the same steps,
    particles and log-likelihoods."""
    from gpbayestools_hic_tpu_torch.samplers.flows import Flow

    _, make = problem
    pc = make("smc_iter")
    ll, state = pc.device_fns["log_likelihood"], pc._like_state
    sharded = ppar.sharded_log_prob(ll, MESH4, state)
    lo, hi = torch.zeros(3, dtype=torch.float64), torch.ones(3, dtype=torch.float64)
    x0 = np.random.default_rng(0).uniform(0.2, 0.8, size=(32, 3))
    u0 = psmc._to_unbounded(torch.tensor(x0), lo, hi)
    lp_x = float(-np.sum(np.log(1.0)))
    _, logl0, logp0, _ = psmc._eval_u(ll, None, state, u0, lo, hi, lp_x)
    out = []
    for fn in (ll, lambda _s, x, finite: sharded(x, finite)):
        flow = Flow(3, CFG, seed=1, dtype=torch.float64, device=CPU)
        gen = torch.Generator().manual_seed(2)
        out.append(psmc._smc_iteration(
            fn, None, state, flow, torch.full((32,), 1 / 32, dtype=torch.float64), u0,
            logl0, logp0, 0.5, torch.tensor(0.5, dtype=torch.float64), gen, lo, hi, lp_x,
            10, 40, kernel="tpcn", patience=0))
    (u_p, l_p, _, _, st_p), (u_s, l_s, _, _, st_s) = out
    assert st_p["steps"] == st_s["steps"]
    np.testing.assert_allclose(u_s.numpy(), u_p.numpy(), rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(l_s.numpy(), l_p.numpy(), rtol=1e-12)


def test_run_pocomc_mesh_matches_single(problem):
    """Chain.run_pocoMC(mesh=): the full contract, and a logz within 3
    combined reported errors + 0.5 of the unsharded run (the JAX test:
    adaptive SMC amplifies reassociation into other, equally valid,
    trajectories); counts that do not divide are refused."""
    _, make = problem
    kw = dict(n_effective=32, n_active=16, n_prior=64, n_max_steps=5, n_total=32,
              n_evidence=16, random_state=0, flow_config=CFG, flow_fit_steps=40,
              checkpoint=False)
    plain = make("smc_plain").run_pocoMC(**kw)
    shard = make("smc_shard").run_pocoMC(**kw, mesh=MESH8)
    assert set(shard) == set(plain) and shard["chain"].shape[1] == 3
    err = np.hypot(plain["logz_err"], shard["logz_err"])
    assert abs(shard["logz"] - plain["logz"]) < 3.0 * err + 0.5, (shard["logz"], plain["logz"])
    with pytest.raises(ValueError, match="n_active particles count 18"):
        make("smc_bad").run_pocoMC(**{**kw, "n_active": 18}, mesh=MESH4)


@pytest.mark.parametrize("pool,counts", [(4, (64, 16, 16)), (12, (64, 16, 16)),
                                         (4, (64, 16, 6)), (8, (64, 12, 16)), (1, (64, 16, 16)),
                                         (None, (64, 16, 16))])
def test_pool_maps_to_devices_as_in_jax(problem, eight_cards, monkeypatch, pool, counts):
    """An integer pool with no devices/mesh asks for min(pool, device count)
    devices when n_prior, n_active and n_evidence divide over them, and is
    ignored otherwise: the port makes JAX's decision (its CUDA count set
    to JAX's 8 CPU devices); an explicit mesh wins."""
    from gpbayestools_hic_tpu.samplers import smc as jsmc

    jc, make = problem

    class Stop(Exception):
        pass

    got = {}

    def spy(tag):
        def run(*a, mesh=None, **kw):
            got[tag] = None if mesh is None else (
                mesh.size if isinstance(mesh, WalkerMesh) else mesh.devices.size)
            raise Stop
        return run

    monkeypatch.setattr(psmc, "run_smc", spy("port"))
    monkeypatch.setattr(jsmc, "run_smc", spy("jax"))
    n_prior, n_active, n_evidence = counts
    kw = dict(n_prior=n_prior, n_active=n_active, n_effective=64, n_evidence=n_evidence,
              pool=pool, checkpoint=False)
    pc = make("pool")
    for call in (lambda: pc.run_pocoMC(**kw), lambda: jc.run_pocoMC(**kw)):
        with pytest.raises(Stop):
            call()
    assert got["port"] == got["jax"]
    with pytest.raises(Stop):
        pc.run_pocoMC(**kw, mesh=WalkerMesh([CPU] * 2))
    assert got["port"] == 2


def test_more_devices_than_cards_raise_before_any_work(problem, monkeypatch):
    """devices=2 with one card raises make_mesh's ValueError at every
    front-end before the posterior is built: nothing falls back to fewer
    devices or to the CPU."""
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    c = make = problem[1]
    c = make("too_many")
    calls = (lambda: c.run_mcmc(nsteps=2, nburnsteps=2, nwalkers=8, devices=2),
             lambda: c.run_MCMC_HMC(nsteps=2, nwalkers=8, devices=2),
             lambda: c.run_MCMC_PTLMC(nsteps=2, nwalkers=8, ntemps=8, devices=2),
             lambda: c.run_pocoMC(devices=2))
    for call in calls:
        with pytest.raises(ValueError, match="requested 2 devices but only 1 available"):
            call()
    assert c._device_fns is None and not c.mcmc_path.exists()
