"""``morph_recon_roofline.wsi``: the reconstruction alone, both calls a tile
(``fill_holes`` and the opening's ``morph_recon``): their bound over the
device time of the kernels they launched."""
from rtbench.trace import roofline_share


def read(run):
    return roofline_share(run, ("fill_holes", "morph_recon"))
