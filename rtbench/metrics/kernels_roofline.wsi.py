"""``kernels_roofline.wsi``: the tile's ops (``color_deconv``, ``fill_holes``,
``morph_recon``, ``connected_components``, ``texture_features``; outermost
op span only): their summed bound (``counts/``) over the device time of the
kernels they launched (``trace.summarize``)."""
from rtbench.trace import roofline_share

OPS = ("color_deconv", "fill_holes", "morph_recon", "connected_components", "texture_features")


def read(run):
    return roofline_share(run, OPS)
