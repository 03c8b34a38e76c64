"""``python -m new_cg_variants_tpu_torch solve | convergence | scaling``."""

from .cli import main

if __name__ == "__main__":
    raise SystemExit(main())
