"""The cross-pair ILP forward against the JAX package's, on the CPU: the
plain version of `sw_forward_split` against the Pallas `_kernel_split` of
tests/sanitize/ilp_probe.py in interpret mode (x64 off, as the harness
traces it), the wrapper's routing and checks, and the probe's inputs.
Pallas dirs are (Dpad, Q, B) indexed [q + t, q, b]; they are read into
the port's (B, Q, T) and compared on valid cells only. Everything is
integer and made from a seed: every comparison is exact."""

import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from rabbitsalign_tpu.ops.sw_jax import SwParams as JaxSwParams
from rabbitsalign_tpu_torch.ops import extend_device as px
from rabbitsalign_tpu_torch.ops import sw_cuda
from rabbitsalign_tpu_torch.ops.sw_cuda import SwParams
from rabbitsalign_tpu_torch.tools import ilp_probe

from .torch_extend_cases import mixed_pairs, q2_batch

SW = SwParams(2, 8, 12, 1)


def _jax_ilp_probe():
    path = Path(__file__).resolve().parent / "sanitize" / "ilp_probe.py"
    spec = importlib.util.spec_from_file_location("sanitize_ilp_probe", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _pallas_dirs_bqt(jd, Q, T):
    """Pallas (Dpad, Q, B) dirs as (B, Q, T): cell (q, t) from [q + t, q]."""
    qs, ts = np.meshgrid(np.arange(Q), np.arange(T), indexing="ij")
    return np.ascontiguousarray(jd[qs + ts, qs, :].transpose(2, 0, 1))


def _codes(Q, T, B, seed):
    """(q_t, t_t, qlen, tlen) CPU tensors of the mixed pair set."""
    buf, genome = q2_batch(mixed_pairs(Q, T, B, seed=seed), Q, seed=seed)
    return px.unpack_q2(torch.from_numpy(buf), px.resident_ref_codes(genome, "cpu"), Q, T)


@pytest.mark.parametrize("split", [2, 4])
def test_split_plain_matches_pallas_kernel_split(split):
    Q, T, B = 24, 40, 256
    q_t, t_t, qlen, tlen = _codes(Q, T, B, seed=5 + split)
    forward = _jax_ilp_probe().make_variant(split)
    with pltpu.force_tpu_interpret_mode(), jax.enable_x64(False):
        js, jte, jqe, jd = (np.asarray(x) for x in forward(
            jnp.asarray(q_t.numpy()), jnp.asarray(t_t.numpy()), jnp.asarray(qlen.numpy()),
            jnp.asarray(tlen.numpy()), JaxSwParams(*SW)))
    ps, pte, pqe, pd = (x.numpy() for x in sw_cuda.sw_forward_split_plain(
        q_t, t_t, qlen, tlen, SW, split))
    np.testing.assert_array_equal(ps, js)
    np.testing.assert_array_equal(pte, jte)
    np.testing.assert_array_equal(pqe, jqe)
    assert (ps > 0).sum() > B // 2
    valid = sw_cuda.valid_cells(qlen, tlen, Q, T).numpy()
    assert pd.shape == (B, Q, T)
    np.testing.assert_array_equal(pd[valid], _pallas_dirs_bqt(jd, Q, T)[valid])


@pytest.mark.parametrize("split", [2, 4])
def test_split_wrapper_on_cpu_runs_the_plain_version(split):
    q_t, t_t, qlen, tlen = _codes(32, 48, 28, seed=3)
    launches = sw_cuda.launches_split
    got = sw_cuda.sw_forward_split(q_t, t_t, qlen, tlen, SW, split)
    assert sw_cuda.launches_split == launches
    for a, b in zip(got, sw_cuda.sw_forward_split_plain(q_t, t_t, qlen, tlen, SW, split)):
        assert torch.equal(a, b)
    # column groups are independent: the split equals the one-pair forward,
    # dirs in the same (B, Q, T) layout
    one = sw_cuda.sw_forward_plain(q_t, t_t, qlen, tlen, SW)
    for a, b in zip(got[:3], one[:3]):
        assert torch.equal(a, b)
    assert got[3].shape == (28, 32, 48)
    assert torch.equal(got[3], one[3])


@pytest.mark.parametrize("split,B", [(3, 24), (8, 24), (4, 30), (2, 27)],
                         ids=["split3", "split8", "B30-split4", "B27-split2"])
def test_split_rejects_bad_split_or_width(split, B):
    q_t, t_t, qlen, tlen = _codes(16, 24, B, seed=1)
    for fn in (sw_cuda.sw_forward_split, sw_cuda.sw_forward_split_plain):
        with pytest.raises(ValueError):
            fn(q_t, t_t, qlen, tlen, SW, split)
    with pytest.raises(ValueError):  # checked before any launch
        sw_cuda.sw_forward_split(q_t.to("meta"), t_t.to("meta"), qlen.to("meta"),
                                 tlen.to("meta"), SW, split)


def test_probe_inputs_are_the_harness_inputs():
    q_t, t_t, qlen, tlen = ilp_probe.probe_inputs()
    Q, T, B = ilp_probe.Q, ilp_probe.T, ilp_probe.B
    assert (Q, T, B) == (152, 256, 1024)
    assert q_t.shape == (Q, B) and t_t.shape == (T, B)
    assert q_t.dtype == t_t.dtype == torch.uint8 and qlen.dtype == tlen.dtype == torch.int32
    assert q_t.is_contiguous() and t_t.is_contiguous()
    assert int(qlen.min()) >= 100 and int(qlen.max()) <= Q
    assert int(tlen.min()) >= 150 and int(tlen.max()) <= T
    for a, b in zip((q_t, t_t, qlen, tlen), ilp_probe.probe_inputs()):
        assert torch.equal(a, b)
    # the draw of tests/sanitize/ilp_probe.py:218-227, in its (B, Q) layout
    rng = np.random.RandomState(7)
    q = rng.randint(0, 4, (B, Q)).astype(np.uint8)
    np.testing.assert_array_equal(q_t.numpy().T, q)
    # planted pairs: the query's prefix appears in the target
    t = t_t.numpy().T
    assert all(q[i, :100].tobytes() in t[i].tobytes() for i in range(0, B, 3))
    assert ilp_probe.PARAMS == SwParams(2, 8, 12, 1)


def test_ilp_probe_refuses_to_run_without_a_gpu(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert ilp_probe.main() == 1
    assert "needs an NVIDIA GPU" in capsys.readouterr().err
