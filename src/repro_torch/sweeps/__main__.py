import sys

from repro_torch.sweeps.cli import main

if __name__ == "__main__":
    sys.exit(main())
