"""``ops.color_deconv(rgb (3, H, W), minv (3, 3))``: the RGB read once, the three
stain planes written once, the 3x3 inverse read once; 24 operations a pixel
(three clamps and logarithms, nine products, six sums, three scalings)."""

# the kernels of ``kernels/csrc/color_deconv.cu`` that the op launches
KERNELS = ("color_deconv_kernel",)


def count(args, kwargs):
    rgb = args[0] if args else kwargs["rgb"]
    hw = rgb.shape[-1] * rgb.shape[-2]
    return 24 * hw, 2 * 3 * hw * rgb.element_size() + 9 * 4
