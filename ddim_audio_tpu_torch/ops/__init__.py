"""Kernel wrappers and the fused ops built on them.

Every kernel wrapper keeps a plain launch count (``wrapper.launches``);
``launch_counts`` and ``reset_launch_counts`` read and clear them together.
``twin_route`` is the reference route of checks: inside it the wrappers run
their plain twins whatever the device.
"""

from ._cuda import twin_route

from .conv_flat import conv3x3_flat, conv3x3_flat_int8
from .conv_head_tail import conv_head_flat, conv_tail_flat
from .conv_strided import conv_down_flat, conv_up_flat
from .flat_grad import conv_down_dw_flat, conv_dw_flat, conv_up_dw_flat

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
}


def launch_counts() -> dict:
    return {name: fn.launches for name, fn in KERNEL_WRAPPERS.items()}


def reset_launch_counts() -> None:
    for fn in KERNEL_WRAPPERS.values():
        fn.launches = 0
