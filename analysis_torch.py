"""CLI shim of the PyTorch/CUDA port's downstream analyses, shaped like the
JAX package's root scripts:
python analysis_torch.py {biolip,variation,binders,visualize-biolip,
visualize-variation,visualize-binders} [options]
(runs on the card; ``--device cpu`` for the CPU)."""
from caster_dta_torch.device import pin_mkl_code_path
from caster_dta_torch.analysis.cli import main

if __name__ == "__main__":
    pin_mkl_code_path()
    main()
