"""`python -m fadtk_tpu_torch.test` — module-path parity with
`python -m fadtk.test` (reference fadtk/test/__main__.py)."""
from ..cli.test_harness import main

if __name__ == "__main__":
    main()
