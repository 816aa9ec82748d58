"""``pinned_host_share.rt``: the share, in %, of the host-card region bytes
that the program moved through ``staging.upload`` and ``copies.download``
whose host buffer was page-locked before the transfer: uploads of a store
block in a pinned spare and downloads into one, over those and the uploads
staged through pinned memory or handed to the driver's pageable path and
the downloads into pageable spares (``repro_torch.staging.transfer_stats``).
The counter is the program's own, since its last read: the run's warm-up
images with its window. The read takes it and clears it, apart from the
counters that ``store_copied_mb.rt`` and ``staged_upload_share.wsi`` read.
A program without the counter, and a run that moved nothing, read None."""


def read(run):
    try:
        from repro_torch import staging
    except ImportError:
        return None
    if not hasattr(staging, "transfer_stats"):  # a program older than the counter
        return None
    counts = staging.transfer_stats()
    staging.reset_transfer_stats()
    moved = sum(counts[path + "_bytes"] for path in staging.TRANSFERS)
    pinned = counts["upload_pinned_bytes"] + counts["download_pinned_bytes"]
    return 100.0 * pinned / moved if moved else None
