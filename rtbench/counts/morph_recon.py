"""``ops.morph_recon(marker, mask)``: marker and mask read once, the result
written once; at least one pass of the four neighbours' maximum and the
mask's minimum over every pixel (8 operations a pixel)."""

# the kernels of ``kernels/csrc/morph_recon.cu`` that the op launches
KERNELS = ("recon_round",)


def count(args, kwargs):
    mask = args[1] if len(args) > 1 else kwargs["mask"]
    hw = mask.shape[-1] * mask.shape[-2]
    return 8 * hw, 3 * hw * mask.element_size()
