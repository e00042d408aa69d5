"""Physics-based raw noise model (counterpart of ``eld_tpu.noise``):
calibrated parameter sampling, the plain PyTorch noise model, and the
fused CUDA kernel (``noise/kernels.py``)."""

from eld_tpu_torch.noise.params import (  # noqa: F401
    CAMERA_NAMES,
    SATURATION_DEFAULT,
    CameraParamsBank,
    NoiseParams,
    load_camera_params,
    sample_params,
    sample_params_batch,
)
from eld_tpu_torch.noise.model import expand_model, noise_core, synthesize  # noqa: F401
