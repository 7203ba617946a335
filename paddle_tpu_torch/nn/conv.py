"""Convolution layers (mirrors ``paddle_tpu/nn/layer/conv.py``): ``Conv2D``.

The other conv layers are not ported yet.
"""

from __future__ import annotations

from torch import nn

from ..core.device import resolve_device
from . import functional as F
from .initializer import Constant, XavierNormal
from .layers import _init


class Conv2D(nn.Module):
    """2-d convolution (``paddle_tpu/nn/layer/conv.py:68``): weight
    [out, in / groups, kh, kw] drawn by ``XavierNormal`` (fan_in = in/groups
    * kh * kw, fan_out = out * kh * kw), bias [out] at 0 unless
    ``bias_attr=False``. ``stride``, ``padding``, ``dilation``, ``groups``
    and ``data_format`` as ``nn.functional.conv2d`` takes them. Parameters
    are made on ``device`` (default ``cuda``) in ``dtype`` from
    ``generator``."""

    def __init__(self, in_channels, out_channels, kernel_size, stride=1,
                 padding=0, dilation=1, groups=1, padding_mode="zeros",
                 weight_attr=None, bias_attr=None, data_format="NCHW", *,
                 device=None, dtype=None, generator=None,
                 requires_grad=False):
        super().__init__()
        if in_channels % groups != 0:
            raise ValueError("in_channels must be divisible by groups")
        if padding_mode != "zeros" or weight_attr is not None or \
                bias_attr not in (None, False):
            raise NotImplementedError(
                "Conv2D takes padding_mode='zeros', weight_attr=None and "
                "bias_attr None or False only")
        device = resolve_device(device)
        kernel = F._tuplize(kernel_size, 2)
        self.stride, self.padding, self.dilation = stride, padding, dilation
        self.groups, self.data_format = groups, data_format
        kw = dict(device=device, dtype=dtype, generator=generator,
                  requires_grad=requires_grad)
        self.weight = _init(XavierNormal(),
                            (out_channels, in_channels // groups, *kernel),
                            **kw)
        self.bias = None if bias_attr is False else \
            _init(Constant(0.0), (out_channels,), **kw)

    def forward(self, x):
        return F.conv2d(x, self.weight, self.bias, self.stride, self.padding,
                        self.dilation, self.groups, self.data_format)
