"""Train and save one sklearn-head emulator and one PCSK emulator per
observable group, on ``device`` (default CUDA).  Run
``make_synthetic_dataset.py`` first.

    python emulator_training.py [device]
"""

import sys
from pathlib import Path

from gpbayestools_hic_tpu_torch.models import Emulator, EmulatorBAND

DATA = Path("synthetic_data")
GROUPS = ("dNdy", "meanpT", "vn")


def main(device=None, gp_maxiter: int = 200):
    parfile = DATA / "model_params.txt"
    for group in GROUPS:
        train_pkl = DATA / f"training_data_{group}.pkl"

        emu = Emulator(str(train_pkl), str(parfile), npc=4, gp_maxiter=gp_maxiter,
                       device=device)
        emu.trainEmulatorAutoMask()
        emu.save(DATA / f"emulator_sklearn_{group}.sav")

        pcsk = EmulatorBAND(str(train_pkl), str(parfile), method="PCSK",
                            gp_maxiter=gp_maxiter, device=device)
        pcsk.trainEmulatorAutoMask()
        pcsk.save(DATA / f"emulator_pcsk_{group}.sav")
        print(f"{group}: sklearn-head LML {float(emu.gp_state.lml.sum()):.1f}, "
              f"PCSK {pcsk._npc_used} PCs")


if __name__ == "__main__":
    main(sys.argv[1] if len(sys.argv) > 1 else None)
