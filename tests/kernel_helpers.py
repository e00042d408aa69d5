"""A step through the port's dispatcher-operator kernels, shared by the
CPU tests and their card twins."""

import torch

from eld_tpu_torch.models.epilogue import bias_lrelu
from eld_tpu_torch.models.layernorm import biasfree_layernorm


def kernel_operator_step(device):
    """A step through the conv epilogue and the LayerNorm, forward and
    backward, on (2, 8, 4, 4) f32 NHWC tensors of ``device``; and the bytes
    of its four operators' inputs and outputs, each counted once: 10 of
    those tensors and 5 of the (8,) f32 vectors."""
    gen = torch.Generator().manual_seed(0)

    def draw(*shape):
        t = torch.randn(shape, generator=gen).to(device)
        return t.contiguous(memory_format=torch.channels_last) if len(shape) == 4 else t

    z, gy = draw(2, 8, 4, 4), draw(2, 8, 4, 4)
    bias, weight = draw(8).requires_grad_(), draw(8).requires_grad_()
    z.requires_grad_()

    def step(state, batch, seed):
        y = biasfree_layernorm(bias_lrelu(z, bias), weight)
        torch.autograd.grad(y, (z, bias, weight), gy)
        return {}

    # bias_lrelu: z, bias -> y1;  biasfree_layernorm: y1, weight -> y;
    # its backward: gy, y1, weight -> gx, gw;  lrelu_bias_backward: gx, y1 -> gz, gbias
    return step, 10 * z.nbytes + 5 * bias.nbytes
