"""`python -m fadtk_tpu_torch.package` — module-path parity with
`python -m fadtk.package` (reference fadtk/package.py)."""
from .cli.package import main

if __name__ == "__main__":
    main()
