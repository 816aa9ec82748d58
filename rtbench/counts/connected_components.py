"""``ops.connected_components(mask)``: the mask read once and the int32 labels
written once; a comparison with each of two neighbours and a minimum a
pixel (4 operations)."""

# the kernels of ``kernels/csrc/ccl.cu`` that the op launches
KERNELS = ("ccl_local", "ccl_border", "ccl_compress")


def count(args, kwargs):
    mask = args[0] if args else kwargs["mask"]
    hw = mask.shape[-1] * mask.shape[-2]
    return 4 * hw, hw * mask.element_size() + hw * 4
