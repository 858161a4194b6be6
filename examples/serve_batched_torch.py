"""Continuous-batched serving on the PyTorch port, the counterpart of
``examples/serve_batched.py``: the port's ``launch.serve.main`` with the
same arguments (smollm-360m's smoke config, 4 requests, 24 new tokens, a
128-row cache).  On the card by default, where the server decodes through
its captured CUDA graph; ``--device cpu`` runs the plain PyTorch path.
Ends with ``OK``.

  PYTHONPATH=src python examples/serve_batched_torch.py [--device cpu]
"""
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

from repro_torch.launch.serve import main

ARGS = ["--arch", "smollm-360m", "--smoke", "--n-requests", "4", "--max-new", "24",
        "--max-len", "128"]

if __name__ == "__main__":
    main(ARGS + sys.argv[1:])
