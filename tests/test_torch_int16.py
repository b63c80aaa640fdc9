"""The port's int16 path against the JAX package's, on the CPU: the
`RSB_SW16` dtype rule, the probe, and the forward's int16 configuration.

The Pallas kernels themselves run here in interpret mode
(`pltpu.force_tpu_interpret_mode`, with x64 off as sw_forward_pallas
traces them), so the port's plain versions are held against the TPU
kernels' own arithmetic, not only against their lax.scan twins. Pallas
dirs are (Dpad, Q, B) indexed [q + t, q, b] and are defined on valid
cells only, so only those are compared. Everything is integer and made
from a seed: every comparison is exact.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from rabbitsalign_tpu.cli import main as jax_main
from rabbitsalign_tpu.ops import sw_pallas
from rabbitsalign_tpu.ops.sw_jax import SwParams as JaxSwParams
from rabbitsalign_tpu_torch.cli import main as port_main
from rabbitsalign_tpu_torch.native.engine import engine_buckets
from rabbitsalign_tpu_torch.ops import cuda_build, extend_device, sw_cuda
from rabbitsalign_tpu_torch.ops import extend_device as px
from rabbitsalign_tpu_torch.ops import int16_probe as probe
from rabbitsalign_tpu_torch.ops.sw_cuda import SwParams

from .test_torch_e2e import _without_pg, data  # noqa: F401  (module fixture)
from .torch_extend_cases import mixed_pairs, q2_batch

BUCKETS = [(q, t) for q, t, _, _ in engine_buckets(150)]
PARAMS = [SwParams(2, 8, 12, 1), SwParams(1, 1, 2, 1), SwParams(100, 8, 12, 1)]


def _codes(Q, T, B, seed):
    """(q_t, t_t, qlen, tlen) CPU tensors of the mixed pair set."""
    buf, genome = q2_batch(mixed_pairs(Q, T, B, seed=seed), Q, seed=seed)
    return px.unpack_q2(torch.from_numpy(buf), px.resident_ref_codes(genome, "cpu"), Q, T)


@pytest.mark.parametrize("env", [None, "0", "1", "yes"], ids=["unset", "0", "1", "yes"])
def test_pick_dtype_matches_jax(monkeypatch, env):
    if env is None:
        monkeypatch.delenv("RSB_SW16", raising=False)
    else:
        monkeypatch.setenv("RSB_SW16", env)
    shapes = BUCKETS + [(24, 40), (64, 128), (8, 8), (1024, 4096)]
    picks = set()
    for Q, T in shapes:
        for sw in PARAMS:
            port = sw_cuda.pick_dtype(Q, T, sw)
            assert str(port) == f"torch.{jnp.dtype(sw_pallas._pick_dtype(Q, T, JaxSwParams(*sw))).name}"
            picks.add(port)
    assert picks == ({torch.int32} if env in (None, "0") else {torch.int16, torch.int32})
    if env in ("1", "yes"):
        # default scoring moves every bucket to int16; the span bound keeps
        # a large match score at the widest bucket on int32
        assert all(sw_cuda.pick_dtype(Q, T, PARAMS[0]) == torch.int16 for Q, T in BUCKETS)
        assert sw_cuda.pick_dtype(512, 2048, SwParams(100, 8, 12, 1)) == torch.int32


def _pallas_probe(x):
    """The Pallas probe's kernel body, rabbitsalign_tpu/ops/sw_pallas.py:99-102
    (a closure there, so restated here), run in interpret mode."""
    def _k(a_ref, o_ref):
        a = a_ref[:]
        b = pltpu.roll(a, shift=1, axis=0)
        o_ref[:] = jnp.where(a < b, a, b)

    with pltpu.force_tpu_interpret_mode(), jax.enable_x64(False):
        fn = pl.pallas_call(
            _k, out_shape=jax.ShapeDtypeStruct(x.shape, jnp.int16),
            in_specs=[pl.BlockSpec(memory_space=pltpu.VMEM)],
            out_specs=pl.BlockSpec(memory_space=pltpu.VMEM),
        )
        return np.asarray(fn(jnp.asarray(x)))


@pytest.mark.parametrize("seed", [0, 1])
def test_probe_plain_matches_pallas_probe(seed):
    x = probe.probe_input(seed)
    assert x.shape == probe.PROBE_SHAPE and x.dtype == np.int16
    assert (x == -32768).any() and (x == 32767).any()
    assert (x == np.roll(x, 1, 0)).any()  # equal neighbours
    launches = probe.launches
    got = probe.int16_probe(torch.from_numpy(x))  # a CPU tensor: the plain version
    np.testing.assert_array_equal(got.numpy(), _pallas_probe(x))
    np.testing.assert_array_equal(probe.int16_probe_plain(torch.from_numpy(x)).numpy(),
                                  got.numpy())
    assert probe.launches == launches


def _pallas_forward(q_t, t_t, qlen, tlen, sw):
    with pltpu.force_tpu_interpret_mode(), jax.enable_x64(False):
        score, t_end, q_end, dirs, _, _ = sw_pallas._sw_forward_pallas_core(
            jnp.asarray(q_t.numpy()), jnp.asarray(t_t.numpy()), jnp.asarray(qlen.numpy()),
            jnp.asarray(tlen.numpy()), JaxSwParams(*sw))
        return tuple(np.asarray(x) for x in (score, t_end, q_end, dirs))


@pytest.mark.parametrize("sw16", ["1", "0"], ids=["int16", "int32-split2"])
def test_plain_forward_matches_pallas_kernel(monkeypatch, sw16):
    """Under RSB_SW16=1 the Pallas core runs its int16 kernel, and the
    port's plain forward its int16 configuration; under RSB_SW16=0 both
    run int32 (the Pallas core with SPLIT=2 lane halves at B=256)."""
    monkeypatch.setenv("RSB_SW16", sw16)
    Q, T, B = 24, 40, 256
    sw = SwParams(2, 8, 12, 1)
    acc = sw_cuda.pick_dtype(Q, T, sw)
    assert acc == (torch.int16 if sw16 == "1" else torch.int32)
    q_t, t_t, qlen, tlen = _codes(Q, T, B, seed=11)
    js, jte, jqe, jd = _pallas_forward(q_t, t_t, qlen, tlen, sw)
    ps, pte, pqe, pd = sw_cuda.sw_forward_plain(q_t, t_t, qlen, tlen, sw, acc)
    np.testing.assert_array_equal(ps.numpy(), js)
    np.testing.assert_array_equal(pte.numpy(), jte)
    np.testing.assert_array_equal(pqe.numpy(), jqe)
    assert (ps > 0).sum() > B // 2
    _assert_dirs_equal_on_valid_cells(pd, jd, qlen, tlen)


def _assert_dirs_equal_on_valid_cells(pd, jd, qlen, tlen):
    """The port's (B, Q, T) dirs, through permute_dirs, against the Pallas
    (Dpad, Q, B) dirs on the valid cells (the only ones either defines)."""
    B, Q, T = pd.shape
    valid = sw_cuda.permute_dirs(sw_cuda.valid_cells(qlen, tlen, Q, T).to(torch.uint8), "dqb")
    valid = valid.numpy() == 1
    assert jd.shape == valid.shape
    np.testing.assert_array_equal(sw_cuda.permute_dirs(pd, "dqb").numpy()[valid], jd[valid])


@pytest.mark.parametrize("case", ["int16", "int32", "int16-extreme"])
def test_plain_forward_edges_match_pallas_kernel(monkeypatch, case):
    """Q not a multiple of 32 and lengths of 0, Q and T (and past them), in
    both configurations; "int16-extreme" takes the largest match score
    that pick_dtype still admits to int16 at this shape, on pairs whose
    query is the target (scores near 2**14), beside the mixed pairs."""
    Q, T, B = 40, 56, 128
    monkeypatch.setenv("RSB_SW16", "0" if case == "int32" else "1")
    q_t, t_t, qlen, tlen = _codes(Q, T, B, seed=21)
    qlen[1], tlen[2], qlen[3], tlen[3], qlen[4], tlen[4] = 0, 0, Q, T, Q + 9, T + 2
    qlen[5], tlen[5] = 0, 0
    sw = SwParams(2, 8, 12, 1)
    if case == "int16-extreme":
        A = max(a for a in range(1, 2000)
                if sw_cuda.pick_dtype(Q, T, SwParams(a, 8, 12, 1)) == torch.int16)
        assert sw_cuda.pick_dtype(Q, T, SwParams(A + 1, 8, 12, 1)) == torch.int32
        sw = SwParams(A, 8, 12, 1)
        for b in range(8, B, 4):  # the query is the target's prefix: score A * qlen
            q_t[:, b] = t_t[:Q, b]
            qlen[b] = tlen[b] = Q
    acc = sw_cuda.pick_dtype(Q, T, sw)
    assert acc == (torch.int32 if case == "int32" else torch.int16)
    js, jte, jqe, jd = _pallas_forward(q_t, t_t, qlen, tlen, sw)
    ps, pte, pqe, pd = sw_cuda.sw_forward_plain(q_t, t_t, qlen, tlen, sw, acc)
    np.testing.assert_array_equal(ps.numpy(), js)
    np.testing.assert_array_equal(pte.numpy(), jte)
    np.testing.assert_array_equal(pqe.numpy(), jqe)
    assert (ps[1], pte[1], pqe[1]) == (0, -1, 0) and (ps[2], pte[2], pqe[2]) == (0, -1, 0)
    if case == "int16-extreme":
        assert int(ps.max()) == sw.match * Q > 16000  # H near 2**14, E near NEG16 - D
    _assert_dirs_equal_on_valid_cells(pd, jd, qlen, tlen)


@pytest.mark.parametrize("Q,T", BUCKETS)
def test_plain_int16_equals_plain_int32(Q, T):
    sw = SwParams(2, 8, 12, 1)
    q_t, t_t, qlen, tlen = _codes(Q, T, 14, seed=Q + T)
    a = sw_cuda.sw_forward_plain(q_t, t_t, qlen, tlen, sw, torch.int16)
    b = sw_cuda.sw_forward_plain(q_t, t_t, qlen, tlen, sw, torch.int32)
    for x, y in zip(a, b):
        assert x.dtype == y.dtype and torch.equal(x, y)
    assert (a[0] > 0).sum() > 7


def test_cli_int16_matches_jax(data, monkeypatch):  # noqa: F811
    """RSB_SW16=1 --device cpu: every dispatched batch runs the plain
    forward in int16, and the SAM equals the JAX CLI's."""
    monkeypatch.setenv("RSB_SW16", "1")
    accs = []
    plain = sw_cuda.sw_forward_plain

    def spy(*args):
        accs.append(args[5])
        return plain(*args)

    monkeypatch.setattr(sw_cuda, "sw_forward_plain", spy)
    argv = [str(data / "ref.fa"), str(data / "se.fq"), "-t", "1", "--tpu-batch", "64"]
    assert jax_main(argv + ["-o", str(data / "i16.jax.sam")]) == 0
    calls = extend_device.calls
    assert port_main(argv + ["--device", "cpu", "-o", str(data / "i16.port.sam")]) == 0
    assert extend_device.calls > calls
    assert accs and set(accs) == {torch.int16}
    assert _without_pg(data / "i16.port.sam") == _without_pg(data / "i16.jax.sam")


def test_failed_kernel_build_raises(monkeypatch, tmp_path):
    """No hidden fallback: an nvcc that fails makes the build raise."""
    monkeypatch.setattr(cuda_build, "nvcc_path", lambda: "false")
    monkeypatch.setattr(cuda_build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(cuda_build, "LIB_PATH", tmp_path / "libsw_kernels.so")
    with pytest.raises(RuntimeError, match="CUDA kernel build failed"):
        cuda_build.build_kernels()
    assert not (tmp_path / "libsw_kernels.so").exists()
    assert list(tmp_path.iterdir()) == []  # objects and partial library removed


def test_probe_refuses_a_non_cuda_device():
    with pytest.raises(ValueError):
        probe.probe_int16_lowering("cpu")
    with pytest.raises(ValueError):
        probe.int16_probe(torch.zeros(probe.PROBE_SHAPE, dtype=torch.int16, device="meta"))
