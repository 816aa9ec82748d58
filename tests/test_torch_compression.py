"""The port's gradient-compression collectives against the reference's: the
same numpy inputs summed over the ``pod`` axis of a (pod=2, data=2) mesh in
fp32, bf16 and int8, the port in four ``gloo`` processes, the reference's
``shard_map`` in a subprocess with four host devices (as
``tests/test_compression.py`` runs it); plus the reference file's
quantization and ratio checks on the port."""
import json
import os
import subprocess
import sys

import numpy as np
import torch

from repro.train.compression import compression_ratio as ref_ratio
from repro_torch.train.compression import compressed_psum_tree, compression_ratio
from tests._torch_dist import spawn

MODES = ("fp32", "bf16", "int8")


def _inputs() -> np.ndarray:
    """One row a rank, rows of different scales (int8 takes each rank's own
    max-abs scale)."""
    rng = np.random.default_rng(0)
    return (rng.standard_normal((4, 64)) * np.array([[1.0], [3.0], [0.01], [200.0]])).astype(
        np.float32)


_REF = r"""
import os
# four host devices on one thread each: the other test workers share the cores
os.environ["XLA_FLAGS"] = ("--xla_force_host_platform_device_count=4 "
                           "--xla_cpu_multi_thread_eigen=false")
import json, sys
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import PartitionSpec as P
sys.path.insert(0, "src")
from repro.train.compression import compressed_psum

shard_map = getattr(jax, "shard_map", None)
if shard_map is None:
    from jax.experimental.shard_map import shard_map
x = jnp.asarray(np.array(json.loads(sys.argv[1]), np.float32))
mesh = jax.make_mesh((2, 2), ("pod", "data"))
out = {}
for mode in ("fp32", "bf16", "int8"):
    f = jax.jit(shard_map(lambda v: compressed_psum(v, "pod", mode), mesh=mesh,
                          in_specs=P(("pod", "data")), out_specs=P(("pod", "data"))))
    out[mode] = np.asarray(f(x)).tolist()
print("REF " + json.dumps(out))
"""


def _port(rank: int, x: np.ndarray) -> dict:
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.train import make_dp_allreduce

    mesh = make_host_mesh(data=2, model=1, pod=2, device="cpu")
    coord = mesh.get_coordinate()
    row = torch.from_numpy(x[coord[0] * 2 + coord[1]][None])
    got = {m: compressed_psum_tree({"g": row}, "pod", m, mesh)["g"] for m in MODES}
    out = {m: [None] * 4 for m in MODES}
    for m in MODES:
        rows = [torch.empty_like(got[m]) for _ in range(4)]
        torch.distributed.all_gather(rows, got[m])
        out[m] = torch.cat(rows).numpy()
    # the hierarchical reduction: fp32 over data, then bf16 over pod
    tree = make_dp_allreduce(mesh, pod_mode="bf16")({"g": row})
    out["dp"] = tree["g"].numpy()
    return out


def test_compressed_psum_matches_the_reference_in_gloo_processes():
    x = _inputs()
    ref = subprocess.run([sys.executable, "-c", _REF, json.dumps(x.tolist())],
                         capture_output=True, text=True, timeout=300,
                         cwd=os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                         preexec_fn=lambda: os.nice(10))  # below the other test workers
    line = [ln for ln in ref.stdout.splitlines() if ln.startswith("REF ")]
    assert line, ref.stdout + ref.stderr
    want = {m: np.array(v, np.float32) for m, v in json.loads(line[0][4:]).items()}
    got = spawn(_port, 4, x)
    # fp32: the same sum in the same precision
    np.testing.assert_allclose(got["fp32"], want["fp32"], rtol=0, atol=1e-6)
    # bf16: within one bf16 ulp of the result
    ulp = 2.0 ** (np.floor(np.log2(np.maximum(np.abs(want["bf16"]), 1e-30))) - 7)
    assert np.all(np.abs(got["bf16"] - want["bf16"]) <= ulp)
    # int8: each rank's own scale, the dequantized values summed in float32
    np.testing.assert_allclose(got["int8"], want["int8"], rtol=1e-6, atol=0)
    # the plain sums over pod, against numpy
    pod_sum = x.reshape(2, 2, 64).sum(0)
    np.testing.assert_allclose(got["fp32"], np.concatenate([pod_sum, pod_sum]), rtol=1e-6)
    assert got["dp"].shape == (1, 64)
    np.testing.assert_allclose(got["dp"][0], x.sum(0), rtol=1e-2, atol=1e-1)


def test_int8_quantization_roundtrip_error_bound():
    rng = np.random.default_rng(1)
    x = torch.from_numpy(rng.standard_normal(1000).astype(np.float32))
    scale = float(x.abs().max()) / 127.0
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    err = float((q.float() * scale - x).abs().max())
    assert err <= scale / 2 + 1e-7


def test_compression_ratios():
    for mode in MODES:
        assert compression_ratio(mode) == ref_ratio(mode)
    assert compression_ratio("fp32") == 1.0
    assert compression_ratio("bf16") == 2.0
    assert compression_ratio("int8") == 4.0
