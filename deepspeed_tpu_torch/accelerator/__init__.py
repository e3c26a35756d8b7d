"""Device selection for the port.

Counterpart of ``deepspeed_tpu/accelerator/real_accelerator.py``, reduced to
the one decision the port needs: which ``torch.device`` an entry point runs
on. The port runs on the GPU; the CPU is used only when a caller asks for it
(the tests do), never as a silent fallback.
"""

import torch


def get_device(device=None) -> torch.device:
    """``device=None`` means the current CUDA device and raises when there is
    no GPU; any explicit device (``"cpu"``, ``"cuda:1"``, a
    ``torch.device``) is taken as given."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "deepspeed_tpu_torch runs on a CUDA device and none is available; "
            "pass device='cpu' to run the plain PyTorch path on the CPU")
    return torch.device("cuda", torch.cuda.current_device())
