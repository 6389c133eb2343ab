"""Kernel wrappers and the fused ops built on them.

Every kernel wrapper keeps a plain launch count (``wrapper.launches``);
``launch_counts`` reads the ports of the TPU kernels (``KERNEL_WRAPPERS``);
``reset_launch_counts`` clears them and ``batch_sums.launches``
(``ops.sums``: the helper kernel that finishes the statistics sums, a port
of no TPU kernel).
``twin_route`` is the reference route of checks: inside it the wrappers run
their plain twins whatever the device.
"""

from ._cuda import twin_route
from .sums import batch_sums

from .conv_flat import conv3x3_flat, conv3x3_flat_int8, conv3x3_flat_store
from .conv_head_tail import conv_head_flat, conv_tail_flat
from .conv_strided import (
    conv_down_flat,
    conv_down_flat_int8,
    conv_up_flat,
    conv_up_flat_int8,
)
from .flat_grad import conv_down_dw_flat, conv_dw_flat, conv_up_dw_flat
from .residual_affine import residual_affine_flat

KERNEL_WRAPPERS = {
    "conv3x3_flat": conv3x3_flat,
    "conv3x3_flat_int8": conv3x3_flat_int8,
    "conv_head_flat": conv_head_flat,
    "conv_tail_flat": conv_tail_flat,
    "conv_down_flat": conv_down_flat,
    "conv_up_flat": conv_up_flat,
    "conv_dw_flat": conv_dw_flat,
    "conv_down_dw_flat": conv_down_dw_flat,
    "conv_up_dw_flat": conv_up_dw_flat,
    "conv3x3_flat_store": conv3x3_flat_store,
    "residual_affine_flat": residual_affine_flat,
    "conv_down_flat_int8": conv_down_flat_int8,
    "conv_up_flat_int8": conv_up_flat_int8,
}


def launch_counts() -> dict:
    return {name: fn.launches for name, fn in KERNEL_WRAPPERS.items()}


def reset_launch_counts() -> None:
    for fn in (*KERNEL_WRAPPERS.values(), batch_sums):
        fn.launches = 0
