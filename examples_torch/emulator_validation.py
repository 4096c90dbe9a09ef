"""Side-by-side emulator validation with the E and H metrics.

Compares the sklearn-GP head against PCGP and PCSK on held-out points,
printing the RMS relative error E and the uncertainty honesty H, then
scans the holdout size.  Each variant retrains on ``device`` (default
CUDA).  Run ``make_synthetic_dataset.py`` first.

    python emulator_validation.py [device]
"""

import sys
from pathlib import Path

from gpbayestools_hic_tpu_torch.models import Emulator, EmulatorBAND
from gpbayestools_hic_tpu_torch.models.validation import (
    holdout_scan,
    save_metrics_csv,
    validate_multiple_emulators,
)

DATA = Path("synthetic_data")


def main(group: str = "dNdy", n_test_points: int = 20, test_sizes=(10, 30, 60),
         device=None, gp_maxiter: int = 200):
    train_pkl = str(DATA / f"training_data_{group}.pkl")
    parfile = str(DATA / "model_params.txt")
    common = dict(gp_maxiter=gp_maxiter, device=device)
    factories = {
        "sklearn-GP": lambda: Emulator(train_pkl, parfile, npc=4, **common),
        "PCGP": lambda: EmulatorBAND(train_pkl, parfile, method="PCGP", **common),
        "PCSK": lambda: EmulatorBAND(train_pkl, parfile, method="PCSK", **common),
    }
    results = validate_multiple_emulators(factories, n_test_points=n_test_points)
    print(f"\n{'variant':12s} {'mean E':>8s} {'<log H>':>8s}")
    for name, res in results.items():
        print(f"{name:12s} {res['mean_E']:8.4f} {res['mean_log_H']:8.3f}")
    save_metrics_csv(DATA / f"validation_{group}.csv", results)

    scan = holdout_scan(lambda: Emulator(train_pkl, parfile, npc=4, **common),
                        test_sizes=test_sizes)
    print("\nholdout scan:", dict(zip(scan["test_sizes"], scan["mean_E"].round(4))))


if __name__ == "__main__":
    main(device=sys.argv[1] if len(sys.argv) > 1 else None)
