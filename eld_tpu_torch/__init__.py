"""eld_tpu_torch — the PyTorch/CUDA port of eld_tpu for NVIDIA Hopper.

The JAX package ``eld_tpu`` stays beside this one as the reference.  The
port mirrors its module layout (``noise/``, ``models/``, ``train/``,
``data/``, ``tools/``) so that every piece has a counterpart to be held
against, and it never imports JAX: the few framework-free host pieces it
needs are carried here, and ``eld_tpu/data_files`` (camera calibration,
the native patch-store library) is read by path (``_paths.py``).

Conventions:
  * public functions take and return NHWC tensors, the JAX layout; the
    U-Net runs on the ``channels_last`` NCHW view of the same memory;
  * every tensor-producing call takes an explicit ``device`` and every
    random draw an explicit ``torch.Generator``;
  * the one hand-written kernel (fused noise synthesis,
    ``csrc/noise_synth.cu``) is built with nvcc at first use and bound
    with ctypes; CPU tensors take its plain-PyTorch version.
"""

__version__ = "0.3.0"
