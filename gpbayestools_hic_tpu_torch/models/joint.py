"""Joint multi-emulator GP training: one batched fit for a whole ensemble.

Port of the JAX package's ``models/joint.py``.  The flagship calibration
trains one emulator per observable group over the SAME design, so all
their GPs (9 emulators x 4 PCs = 36 on the flagship) are lanes of one
:func:`..models.gp.gp_fit` instead of one fit per emulator.
"""

from __future__ import annotations

import logging
from typing import Sequence

import numpy as np
import torch

from .emulator import Emulator
from .gp import GPState, gp_fit

logger = logging.getLogger(__name__)


def train_emulators_jointly(
    emulators: Sequence[Emulator],
    event_mask=None,
    kernel_type: str | None = None,
    *,
    stats: dict | None = None,
):
    """Train all ``emulators`` in one batched GP fit.

    Requirements (checked): identical (possibly parameter-PCA-transformed)
    design matrices, identical parameter ranges, identical GP settings
    (alpha, maxiter, nrestarts, seed, kernel kind, MAP strength), and one
    device and dtype.  Each emulator ends up as if ``trainEmulator`` had
    been called on it alone -- the GPs are independent, so batching changes
    nothing but the time.  ``kernel_type=None`` uses the emulators' own
    configured kind ("RBF" for this head, its ``trainEmulator`` default).
    ``stats``, when given, receives the optimizer's counts.
    """
    if not emulators:
        return
    if event_mask is None:
        event_mask = np.ones(emulators[0].nev, dtype=bool)
    if kernel_type is None:
        kernel_type = getattr(emulators[0], "kernel_kind_", "RBF")

    designs, zts, ptps, noise_diags, npcs = [], [], [], [], []
    for e in emulators:
        design, z_t, ptp, noise_diag = e._prepare_training(event_mask, kernel_type)
        designs.append(design)
        zts.append(z_t)
        ptps.append(ptp)
        noise_diags.append(torch.zeros_like(z_t) if noise_diag is None else noise_diag)
        npcs.append(z_t.shape[0])

    base = emulators[0]
    for i, e in enumerate(emulators[1:], start=1):
        if (e.device, e._dtype) != (base.device, base._dtype):
            raise ValueError(
                f"emulator {i} lives on {e.device}/{e._dtype}, emulator 0 on "
                f"{base.device}/{base._dtype}"
            )
        if designs[i].shape != designs[0].shape or not torch.allclose(designs[i], designs[0]):
            raise ValueError(
                f"emulator {i} has a different design matrix; joint training "
                "requires a shared experiment design"
            )
        if not np.allclose(ptps[i], ptps[0]):
            raise ValueError(f"emulator {i} has different parameter ranges")
        for attr in ("gp_alpha", "gp_maxiter", "nrestarts", "seed"):
            if getattr(e, attr) != getattr(base, attr):
                raise ValueError(
                    f"emulator {i} differs in {attr}; joint training requires "
                    "identical GP settings"
                )
        for attr in ("kernel_kind_", "gp_map_prior_strength"):
            if getattr(e, attr, None) != getattr(base, attr, None):
                raise ValueError(
                    f"emulator {i} differs in {attr}; joint training requires "
                    "identical GP settings"
                )

    z_all = torch.cat(zts, dim=0)          # (sum npc, nev)
    noise_all = torch.cat(noise_diags, dim=0)
    logger.info(
        "Jointly training %d GPs across %d emulators (%d points) ...",
        z_all.shape[0], len(emulators), designs[0].shape[0],
    )
    state_all: GPState = gp_fit(
        designs[0], z_all, ptps[0], config=base.gp_config,
        nrestarts=base.nrestarts, seed=base.seed, maxiter=base.gp_maxiter,
        noise_diag=noise_all, stats=stats,
    )
    logger.info("joint GP LMLs: %s", state_all.lml.cpu().numpy())

    offsets = np.cumsum([0] + npcs)
    for e, i0, i1 in zip(emulators, offsets[:-1], offsets[1:]):
        e._finalize_training(GPState(
            params={k: v[i0:i1] for k, v in state_all.params.items()},
            x=state_all.x,
            y=state_all.y[i0:i1],
            chol=state_all.chol[i0:i1],
            alpha_vec=state_all.alpha_vec[i0:i1],
            linv=state_all.linv[i0:i1],
            lml=state_all.lml[i0:i1],
        ))
    return emulators
