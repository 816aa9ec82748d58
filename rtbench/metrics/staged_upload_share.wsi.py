"""``staged_upload_share.wsi``: the share, in %, of the host bytes that the
program's uploads (``repro_torch.staging.upload``, under ``pipeline/wsi.py``'s
``_upload``) moved through pinned memory, of all the host bytes they were
handed. The counters are the program's own, since their last read: the run's
warm-up tiles with its window, the same tiles. The read takes them and
clears them, so two runs of one process stay apart. A program without
``staging``, and a run that uploaded nothing, read None."""


def read(run):
    try:
        from repro_torch import staging
    except ImportError:  # a program older than its pinned uploads
        return None
    counts = staging.stats()
    staging.reset_stats()
    moved = counts["staged_bytes"] + counts["direct_bytes"]
    return 100.0 * counts["staged_bytes"] / moved if moved else None
