"""`python -m fadtk_tpu_torch` == the port's `fadtk` CLI (cli/main.py)."""
from .cli.main import main

if __name__ == "__main__":
    main()
