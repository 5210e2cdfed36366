"""beam_opt_step_roofline (%): the float32 Adam step (#2,
``beam_opt_step_kernel``): the least time the card could take for the
lanes of every launch in the traced window (``harness/roofline.py``, semi
or adjoint as launched) over the kernel's summed device time."""

from portbench.harness.roofline import kernel_roofline


def read(r):
    return kernel_roofline(r, ("semi", "adjoint"), ("beam_opt_step_kernel",))
