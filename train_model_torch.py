"""CLI shim of the PyTorch/CUDA port, shaped like train_model.py:
python train_model_torch.py --dataset synthetic --seed 9 --out-folder F
(runs on the card; ``--device cpu`` for the CPU)."""
from caster_dta_torch.device import pin_mkl_code_path
from caster_dta_torch.train.driver import main

if __name__ == "__main__":
    pin_mkl_code_path()
    main()
