"""The paper's example application: segmentation + feature computation on
one tile (``repro.pipeline.wsi``), in its two forms:

  * plain functions (``segment_tile``, ``compute_features``,
    ``analyze_tile``) — the "non-RT" baseline of Fig. 11;
  * region-template stages (``SegmentationStage``, ``FeatureStage``) —
    the RT-based version whose fine-grain operations flow through the WRM
    with per-op speedup estimates (PATS-able), and whose data moves through
    global storage (``make_wsi_storage``).

Both forms run the same steps (``_normalize``, ``_threshold``,
``_open``, ``_nucleus_mask`` below), so on one device their labels agree
bit for bit. Every step runs on one device, from deconvolution to features:
the CUDA card unless the caller passes ``device="cpu"``. ``impl`` is passed
to ``kernels.ops`` (``"auto"``: the kernels on the card, the plain versions
on the CPU; ``"torch"``: the plain versions anywhere). The third form, the
near-data kernel chains (``kernels.chains``), runs in the gateways that
``make_wsi_storage(serve=..., compute=True)`` puts in front of the stores.
"""
from __future__ import annotations

import os
import tempfile
from typing import Any

import numpy as np
import torch

from repro_torch.configs.wsi import PAPER_OP_COSTS, PAPER_OP_SPEEDUPS, WSIConfig
from repro_torch.core import BoundingBox, RegionKind, StorageRegistry
from repro_torch.core.regions import to_numpy
from repro_torch.device import resolve_device
from repro_torch.kernels import ops, ref
from repro_torch.runtime.dag import Stage, Task, TaskCost
from repro_torch.storage import (
    DistributedMemoryStorage,
    PlacementPolicy,
    SocketTransport,
    TieredStore,
    spawn_servers,
)


def _stain_inverse(minv, device: torch.device) -> torch.Tensor:
    m = ref.stain_inverse() if minv is None else minv
    return torch.as_tensor(m, dtype=torch.float32, device=device)


# ---------------------------------------------------------------------------
# The steps both forms run
# ---------------------------------------------------------------------------
def _normalize(hema: torch.Tensor) -> torch.Tensor:
    """Hematoxylin density -> [0, 1] between its 5th and 99.5th percentiles."""
    h_lo, h_hi = ref.percentile(hema, (5.0, 99.5))
    return torch.clamp((hema - h_lo) / torch.clamp(h_hi - h_lo, min=1e-6), 0.0, 1.0)


def _threshold(hema_n: torch.Tensor, cfg: WSIConfig) -> torch.Tensor:
    return (hema_n > cfg.seg_threshold).to(torch.float32)


def _open(filled: torch.Tensor, impl: str) -> torch.Tensor:
    """Morphological reconstruction opening: erode-ish marker then rebuild
    (torch.roll wraps around the tile edge, as jnp.roll does)."""
    marker = torch.minimum(
        filled,
        torch.roll(filled, 1, -1) * torch.roll(filled, -1, -1)
        * torch.roll(filled, 1, -2) * torch.roll(filled, -1, -2),
    )
    return ops.morph_recon(marker, filled, impl=impl)


def _nucleus_mask(opened: torch.Tensor) -> torch.Tensor:
    return (opened > 0.5).to(torch.int32)


# ---------------------------------------------------------------------------
# Plain (non-RT) pipeline functions
# ---------------------------------------------------------------------------
def segment_mask(raw: torch.Tensor, impl: str = "auto") -> dict:
    """Thresholded (H, W) float 0/1 mask -> {"mask", "labels"}: fill holes,
    reconstruction opening, connected components."""
    filled = ops.fill_holes(raw, impl=impl)
    mask = _nucleus_mask(_open(filled, impl))
    labels = ops.connected_components(mask, impl=impl)
    return {"mask": mask, "labels": labels}


def segment_tile(
    rgb, cfg: WSIConfig, impl: str = "auto", device=None, minv=None
) -> dict:
    """RGB (3, H, W) -> {"mask", "labels", "hematoxylin"}.

    ``minv`` is the 3x3 stain inverse (default ``ref.stain_inverse()``).
    """
    dev = resolve_device(device)
    rgb = torch.as_tensor(rgb, dtype=torch.float32, device=dev)
    stains = ops.color_deconv(rgb, _stain_inverse(minv, dev), impl=impl)
    hema_n = _normalize(stains[0])  # hematoxylin density (nuclei stain)
    return {**segment_mask(_threshold(hema_n, cfg), impl=impl), "hematoxylin": hema_n}


def extract_object_rois(
    labels, intensity, cfg: WSIConfig, device=None
) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-object fixed-size ROI batch (replaces dynamic GPU block assignment).

    Returns (rois (K, R, R) float32 intensity crops, boxes (K, 4) int32),
    equal to the reference's: objects in ascending label order, the first
    ``max_objects_per_tile``, each crop centred on its bounding box and
    clipped into the tile, zero-padded where the tile is smaller than R.
    """
    dev = resolve_device(device)
    labels = torch.as_tensor(labels, device=dev)
    intensity = torch.as_tensor(intensity, dtype=torch.float32, device=dev)
    r = cfg.nucleus_roi
    h, w = labels.shape
    flat = labels.reshape(-1)
    pix = torch.nonzero(flat >= 0).squeeze(1)
    ids, slot = torch.unique(flat[pix], sorted=True, return_inverse=True)
    n = ids.numel()
    ys, xs = pix // w, pix % w

    def reduce(init: int, vals: torch.Tensor, how: str) -> torch.Tensor:
        out = torch.full((n,), init, dtype=vals.dtype, device=dev)
        return out.scatter_reduce_(0, slot, vals, how)

    k = min(n, cfg.max_objects_per_tile)
    y0, y1 = reduce(h, ys, "amin")[:k], reduce(-1, ys, "amax")[:k] + 1
    x0, x1 = reduce(w, xs, "amin")[:k], reduce(-1, xs, "amax")[:k] + 1
    cy, cx = (y0 + y1) // 2, (x0 + x1) // 2
    y0 = torch.clamp(cy - r // 2, 0, max(h - r, 0))
    x0 = torch.clamp(cx - r // 2, 0, max(w - r, 0))
    boxes = torch.stack(
        [y0, x0, torch.clamp(y0 + r, max=h), torch.clamp(x0 + r, max=w)], dim=1
    ).to(torch.int32)
    off = torch.arange(r, device=dev)
    rows, cols = y0[:, None] + off, x0[:, None] + off  # (K, R) each
    inside = (rows < h)[:, :, None] & (cols < w)[:, None, :]
    crop = intensity[rows.clamp(max=h - 1)[:, :, None], cols.clamp(max=w - 1)[:, None, :]]
    rois = torch.where(inside, crop, torch.zeros((), dtype=crop.dtype, device=dev))
    return rois, boxes


def compute_features(rois, cfg: WSIConfig, impl: str = "auto", device=None) -> torch.Tensor:
    """(K, R, R) intensity crops -> (K, 9) texture features."""
    dev = resolve_device(device)
    rois = torch.as_tensor(rois, dtype=torch.float32, device=dev)
    if len(rois) == 0:
        return torch.zeros((0, 9), dtype=torch.float32, device=dev)
    bins = ref.quantize_ref(rois, cfg.num_bins)
    return ops.texture_features(bins, cfg.num_bins, impl=impl)


def analyze_tile(
    rgb, cfg: WSIConfig, impl: str = "auto", device=None, minv=None
) -> dict:
    seg = segment_tile(rgb, cfg, impl, device=device, minv=minv)
    rois, boxes = extract_object_rois(seg["labels"], seg["hematoxylin"], cfg, device=device)
    feats = compute_features(rois, cfg, impl, device=device)
    return {**seg, "rois": rois, "boxes": boxes, "features": feats}


# ---------------------------------------------------------------------------
# Storage wiring: flat DMS baseline vs. opt-in tiered hierarchy
# ---------------------------------------------------------------------------
def make_wsi_storage(
    h: int,
    w: int,
    *,
    mode: str = "dms",
    transport: str = "inproc",
    registry: StorageRegistry | None = None,
    root: str | None = None,
    tile: int | None = None,
    num_servers: int = 4,
    server_processes: int = 2,
    endpoints=None,
    replication: int = 1,
    repair=None,
    wire_codec=None,
    membership=None,
    mem_capacity_bytes: int = 64 << 20,
    write_policy: str = "write_through",
    policy: PlacementPolicy | None = None,
    promote_after: int = 2,
    serve=False,
    compute=False,
    device=None,
) -> StorageRegistry:
    """Build the storage backing the WSI stages under the canonical names
    ("DMS3" for the (3, H, W) RGB volume, "DMS2" for the 2-D mask/hema
    domain), so stage bindings never change.

    ``mode="dms"`` is the paper baseline (one DMS per domain);
    ``mode="tiered"`` swaps in :class:`TieredStore` stacks (bounded RAM
    -> DISK -> DMS) behind the same names — the opt-in hierarchy with
    zero call-site changes.

    ``transport`` picks the DMS server link: ``"inproc"`` keeps the
    in-process shards, ``"socket"`` puts the DMS tier on real TCP
    servers, and ``"shm"`` is ``"socket"`` plus the negotiated
    shared-memory data plane — co-located fetches arrive by arena
    reference instead of a TCP stream copy, degrading automatically to
    socket payloads for remote or pre-arena servers.  ``wire_codec``
    (one of ``repro_torch.storage.codec.WIRE_CODECS``, e.g. ``"zlib"``, or a
    per-key glob mapping like ``{"labels/*": "zlib", "feat/*": "bf16"}``)
    compresses socket payloads per connection; raw-vs-wire savings show
    up in ``storage_stats()``.  ``membership`` seeds the stores' elastic
    fleet view (:class:`~repro_torch.storage.membership.RingView`); ``None``
    means the genesis ring, and each store's ``add_server`` /
    ``remove_server`` / ``rebalance`` then resize the fleet live.
    With ``endpoints`` (a list of
    ``(host, port)`` / "host:port"
    addresses, one per server id) the stores attach to an already-running
    fleet; otherwise ``num_servers`` shards are spawned locally across
    ``server_processes`` processes and the started
    :class:`~repro_torch.storage.net.ServerGroup` is attached to the returned
    registry as ``registry.server_group`` — the caller owns it (close it
    after closing the stores).  ``replication=R`` turns on the DMS
    stores' R-way block replication (home + next R-1 servers along the
    SFC ring): reads fail over between replicas and puts re-home blocks
    past dead replicas, so any R-1 dead servers cause zero failed reads
    AND zero failed puts.  ``repair=`` opts into the DMS stores'
    background anti-entropy sweep (``True`` for the 30 s default or a
    float interval in seconds): a crashed server that rejoins empty is
    re-filled until every block has R live copies again; closing the
    stores stops the sweeps.

    In tiered mode the DISK tiers live under ``root`` (subdirs per
    store).  Pass your own ``root`` if you want to clean it up; the
    default is a fresh ``tempfile.mkdtemp`` the caller owns (reachable
    via each store's DISK backend: ``store.tiers[1].backend.root``).

    ``serve`` fronts every store with a
    :class:`~repro_torch.serve.gateway.RegionGateway` (pass ``True`` for the
    defaults or a :class:`~repro_torch.serve.gateway.GatewayConfig`): many
    concurrent clients then share one hierarchy through a bounded,
    request-coalescing worker pool with ``TierStats``-driven admission
    control.  The gateways register under the same names ("DMS3"/
    "DMS2"), so stage bindings never change; closing a gateway closes
    its store.

    ``compute=True`` turns the gateways into the paper's near-data
    analysis service: clients call ``registry.get("DMS3").compute(key,
    roi, "deconv|threshold|ccl")`` and the kernel chain runs server-side
    (the CUDA kernels on the card, the plain versions on the CPU), returning only the
    derived mask/labels/features — an order-of-magnitude egress cut for
    derived-product queries, with a put-generation-invalidated derived
    cache for repeated hot analyses.  ``compute=True`` implies
    ``serve=True``; pass a :class:`~repro_torch.serve.gateway.GatewayConfig`
    via ``serve=`` to size the derived cache (``compute_cache_bytes``)
    or pin the kernel impl (``compute_impl``).  The gateways run their
    chains on ``device``: ``None`` means the CUDA card (raises without
    one), ``"cpu"`` the plain versions on the CPU.
    """

    registry = registry or StorageRegistry()
    dom3 = BoundingBox((0, 0, 0), (3, h, w))
    dom2 = BoundingBox((0, 0), (h, w))
    blk = tile or max(h, w)
    if repair is True:
        repair = 30.0
    repair_interval = None if not repair else float(repair)
    if transport not in ("inproc", "socket", "shm"):
        raise ValueError(
            f"unknown transport {transport!r} (want 'inproc' | 'socket' | 'shm')"
        )
    if transport == "inproc" and wire_codec is not None:
        raise ValueError(
            "wire_codec= needs transport='socket' or 'shm' (in-process shards "
            "move no wire bytes); refusing to silently ignore it"
        )
    if endpoints is not None:
        if transport == "inproc":
            raise ValueError(
                f"endpoints= only makes sense with transport='socket'/'shm' "
                f"(got transport={transport!r}); refusing to silently build "
                f"in-process shards"
            )
        num_servers = len(endpoints)  # one server id per endpoint entry
    shm_mode = "auto" if transport == "shm" else "off"

    def _transport(scope: str):
        """One transport per store: shards are shared across stores, so
        each store scopes its keyspace (and owns its connections)."""
        if transport == "inproc":
            return None
        kw = dict(scope=scope, wire_codec=wire_codec, shm=shm_mode)
        if endpoints is not None:
            return SocketTransport(endpoints, **kw)
        group = getattr(registry, "server_group", None)
        if group is None:
            group = spawn_servers(num_servers, processes=server_processes)
            registry.server_group = group
        return group.transport(**kw)

    if mode == "dms":
        for sname, dom, bshape in (
            ("DMS3", dom3, (3, blk, blk)),
            ("DMS2", dom2, (blk, blk)),
        ):
            dms = DistributedMemoryStorage(
                dom, bshape, num_servers, name=sname,
                transport=_transport(sname), replication=replication,
                membership=membership,
            )
            if repair_interval is not None:
                dms.start_auto_repair(repair_interval)
            registry.register(dms)
    elif mode == "tiered":
        root = root or tempfile.mkdtemp(prefix="wsi_tiers_")
        for name, dom, bshape in (
            ("DMS3", dom3, (3, blk, blk)),
            ("DMS2", dom2, (blk, blk)),
        ):
            registry.register(
                TieredStore.standard(
                    dom,
                    bshape,
                    root=os.path.join(root, name.lower()),
                    name=name,
                    mem_capacity_bytes=mem_capacity_bytes,
                    num_servers=num_servers,
                    write_policy=write_policy,
                    policy=policy,
                    promote_after=promote_after,
                    dms_transport=_transport(name),
                    replication=replication,
                    repair_interval=repair_interval,
                    membership=membership,
                )
            )
    else:
        raise ValueError(f"unknown storage mode {mode!r} (want 'dms' | 'tiered')")
    if compute and not serve:
        serve = True  # near-data compute runs inside the serving gateway
    if serve:
        from repro_torch.serve.gateway import GatewayConfig, RegionGateway

        if isinstance(serve, GatewayConfig):
            gw_config = serve
        elif serve is True:
            gw_config = None  # gateway defaults
        else:
            raise TypeError(
                f"serve= wants True or a GatewayConfig, got {serve!r}; "
                f"refusing to silently ignore gateway settings"
            )
        for name in ("DMS3", "DMS2"):
            registry.register(
                RegionGateway(registry.get(name), config=gw_config, device=device)
            )
    return registry


# ---------------------------------------------------------------------------
# Region-template stages (paper Fig. 8)
# ---------------------------------------------------------------------------
def _task_cost(op: str, scale: float = 1.0, input_bytes: int = 0) -> TaskCost:
    return TaskCost(
        cpu_s=PAPER_OP_COSTS.get(op, 1.0) * scale,
        speedup=PAPER_OP_SPEEDUPS.get(op, 1.0),
        input_bytes=input_bytes,
    )


class SegmentationStage(Stage):
    """Reads "RGB", produces "Mask" (the labels) and "Hema".

    Its fine-grain operations run on ``device`` (``None``: the CUDA card;
    raises at construction without one unless ``device="cpu"``), whichever
    WRM thread takes them: both task variants do the same work there.
    """

    def __init__(self, cfg: WSIConfig | None = None, impl: str = "auto", device=None) -> None:
        super().__init__("Segmentation")
        self.cfg = cfg or WSIConfig()
        self.impl = impl
        self.device = resolve_device(device)

    def run(self, ctx) -> Any:
        dev = self.device
        rgb_region = ctx.region("Patient", "RGB")
        rgb = torch.as_tensor(rgb_region.data, device=dev)
        rt = self.get_region_template("Patient")
        roi = rgb_region.roi
        # mask/hema live on the spatial (H, W) domain; drop the channel axis
        spatial = (
            roi
            if roi.rank == 2
            else BoundingBox(roi.lo[-2:], roi.hi[-2:], roi.t_lo, roi.t_hi)
        )
        mask_region = rt.new_region(
            "Mask", spatial, np.int32, timestamp=rgb_region.key.timestamp
        )
        hema_region = rt.new_region(
            "Hema", spatial, np.float32, timestamp=rgb_region.key.timestamp
        )

        results: dict[str, Any] = {}

        def op(name, fn, deps=(), region_key=None, input_bytes=0):
            def work():
                results[name] = fn()

            return ctx.submit(
                Task(
                    name,
                    cpu_fn=work,
                    accel_fn=work,
                    deps=list(deps),
                    cost=_task_cost(name, input_bytes=input_bytes),
                    region_key=region_key,
                )
            )

        t_deconv = op(
            "Color deconv.",
            lambda: ops.color_deconv(rgb, _stain_inverse(None, dev), impl=self.impl),
            region_key=rgb_region.key,
            input_bytes=rgb_region.nbytes,
        )

        def threshold():
            results["hema_n"] = _normalize(results["Color deconv."][0])
            return _threshold(results["hema_n"], self.cfg)

        t_thr = op("AreaThreshold", threshold, deps=[t_deconv])
        t_fill = op(
            "FillHolles",
            lambda: ops.fill_holes(results["AreaThreshold"], impl=self.impl),
            deps=[t_thr],
        )
        t_recon = op(
            "ReconToNuclei", lambda: _open(results["FillHolles"], self.impl), deps=[t_fill]
        )
        t_label = op(
            "BWLabel",
            lambda: ops.connected_components(
                _nucleus_mask(results["ReconToNuclei"]), impl=self.impl
            ),
            deps=[t_recon],
        )

        def finalize():
            mask_region.set_data(to_numpy(results["BWLabel"]))
            hema_region.set_data(to_numpy(results["hema_n"]))

        ctx.submit(Task("stage-finalize", cpu_fn=finalize, deps=[t_label],
                        cost=TaskCost(cpu_s=0.05)))
        return None


class FeatureStage(Stage):
    """Reads "Mask"+"Hema", produces the "Features" object set, on
    ``device`` as :class:`SegmentationStage` does."""

    def __init__(self, cfg: WSIConfig | None = None, impl: str = "auto", device=None) -> None:
        super().__init__("FeatureComputation")
        self.cfg = cfg or WSIConfig()
        self.impl = impl
        self.device = resolve_device(device)

    def run(self, ctx) -> Any:
        dev = self.device
        mask_region = ctx.region("Patient", "Mask")
        hema_region = ctx.region("Patient", "Hema")
        rt = self.get_region_template("Patient")
        feat_region = rt.new_region(
            "Features",
            mask_region.roi,
            np.float32,
            kind=RegionKind.OBJECTSET,
            timestamp=mask_region.key.timestamp,
        )
        results: dict[str, Any] = {}

        def rois():
            results["rois"], results["boxes"] = extract_object_rois(
                torch.as_tensor(mask_region.data, device=dev),
                torch.as_tensor(hema_region.data, device=dev),
                self.cfg,
                device=dev,
            )

        t_rois = ctx.submit(
            Task(
                "ObjectROIs",
                cpu_fn=rois,
                cost=_task_cost(
                    "BWLabel",
                    input_bytes=mask_region.nbytes + hema_region.nbytes,
                ),
                region_key=mask_region.key,
            )
        )

        def feats():
            f = compute_features(results["rois"], self.cfg, self.impl, device=dev)
            feat_region.set_data({
                "features": to_numpy(f),
                "boxes": to_numpy(results["boxes"]),
            })

        ctx.submit(
            Task("Features", cpu_fn=feats, accel_fn=feats, deps=[t_rois],
                 cost=_task_cost("Features"))
        )
        return None
