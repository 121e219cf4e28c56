"""`python -m fadtk_tpu_torch.embeds` — module-path parity with `fadtk.embeds`
(reference fadtk/embeds.py)."""
from .cli.embeds import main

if __name__ == "__main__":
    main()
