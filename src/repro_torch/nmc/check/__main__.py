"""``python -m repro_torch.nmc.check`` — the static-verification sweep CLI."""

from repro_torch.nmc.check import main

if __name__ == "__main__":
    raise SystemExit(main())
