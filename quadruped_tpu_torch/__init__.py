"""quadruped_tpu_torch: the PyTorch/CUDA port of quadruped_tpu.

The package mirrors the JAX package's layout (mjcf/, assets/, physics/,
ops/, env/, models/) so that each module's counterpart sits at the same
path.  Tensors are batch-first: the env batch rides the leading axis.

Precision rule (quadruped_tpu/physics/forward.py:109-114): every float32
matmul runs in full float32.  TF32 passes break the positive definiteness
of the Newton Hessian and the Cholesky returns NaN, so they are switched
off here, at import, for the whole process.
"""

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
torch.set_float32_matmul_precision("highest")


def resolve_device(device) -> torch.device:
    """The device an entry point runs on.  Entry points default to CUDA
    and never fall back to the CPU on their own: the CPU is used only when
    the caller asks for it."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "device='cuda' requested but torch.cuda.is_available() is False;"
            " pass device='cpu' to run the plain PyTorch path"
        )
    return dev
