"""``ops.texture_features(bins (B, H, W), num_bins)``: the bins read once, each
crop's co-occurrence counts (NB x NB) and histogram (NB) written once as
32-bit counts; a pair and a histogram increment a pixel (2 operations).
The nine features from the counts are some hundred operations a crop."""

# the kernels of ``kernels/csrc/glcm.cu`` that the op launches
KERNELS = ("glcm_kernel", "glcm_packed_kernel", "glcm_global_kernel")


def count(args, kwargs):
    bins = args[0] if args else kwargs["bins"]
    nb = args[1] if len(args) > 1 else kwargs["num_bins"]
    b, h, w = bins.shape[-3], bins.shape[-2], bins.shape[-1]
    return 2 * b * h * w, b * h * w * bins.element_size() + b * (nb * nb + nb) * 4
