"""Generate a MaxPro Latin-hypercube design and write per-point input files.

The design is annealed on ``device`` (default CUDA; ``cpu`` runs on the
host) and cached under ``$WORKDIR/cache/lhs``.

    python generate_LHD_Bayes.py [device]
"""

import sys
from pathlib import Path

from gpbayestools_hic_tpu_torch.design import Design


def main(npoints: int = 100, seed: int = 42, device=None):
    design = Design(Path(__file__).parent / "modelDesign_example.txt",
                    npoints=npoints, seed=seed, device=device)
    design.write_files(Path("./design_points"))
    print(f"wrote {len(design.points)} design points to ./design_points/main")


if __name__ == "__main__":
    main(device=sys.argv[1] if len(sys.argv) > 1 else None)
