"""``ops.fill_holes(mask01)``: one reconstruction of the complement from the
border, counted as ``morph_recon``: marker and mask read once, the result
written once, 8 operations a pixel."""

# the kernels of ``kernels/csrc/morph_recon.cu`` that the op launches
KERNELS = ("recon_round",)


def count(args, kwargs):
    mask = args[0] if args else kwargs["mask01"]
    hw = mask.shape[-1] * mask.shape[-2]
    return 8 * hw, 3 * hw * mask.element_size()
