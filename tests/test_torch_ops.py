"""The port's ops layer against the JAX package's, on the CPU.

Masks and the positional table must be bit-equal. The plain versions of
the two Hopper kernels (what the port's wrappers run for CPU tensors) are
held against the Pallas kernels they replace, run in interpret mode as the
JAX package's own tests run them, and against the JAX fallback. Inputs
come from a numpy seed and cross as numpy arrays. Tolerance: fp32
``atol 2e-5, rtol 1e-5``, the JAX tests' own bound for kernel against
fallback. A CUDA kernel has no interpret mode: its checks against these
plain versions run on the card (``chip_smoke.py`` and the ``gpu`` tests
of ``tests/test_torch_gpu.py``).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from machine_learning_apache_spark_tpu.ops import attention as jattn
from machine_learning_apache_spark_tpu.ops import masks as jmasks
from machine_learning_apache_spark_tpu.ops import pallas_attention as jpallas
from machine_learning_apache_spark_tpu.ops.positional import (
    sinusoidal_encoding as j_sinusoidal,
)
from machine_learning_apache_spark_tpu_torch.ops import attention as tattn
from machine_learning_apache_spark_tpu_torch.ops import hopper_attention as hop
from machine_learning_apache_spark_tpu_torch.ops import masks as tmasks
from machine_learning_apache_spark_tpu_torch.ops.positional import (
    sinusoidal_encoding as t_sinusoidal,
)
from torch_host import one_thread  # noqa: F401 - autouse: one CPU thread a test process

ATOL, RTOL = 2e-5, 1e-5


def _t(x):
    return torch.from_numpy(np.asarray(x))


def _close(got, want):
    np.testing.assert_allclose(
        np.asarray(got), np.asarray(want), atol=ATOL, rtol=RTOL
    )


class TestMasksAndPositional:
    @pytest.mark.parametrize("sq,sk", [(4, 4), (3, 7), (6, 2)])
    def test_causal_mask_bit_equal(self, sq, sk):
        want = np.asarray(jmasks.make_causal_mask(sq, sk))
        got = tmasks.make_causal_mask(sq, sk).numpy()
        np.testing.assert_array_equal(got, want)

    def test_padding_attention_segment_combine_bit_equal(self):
        rng = np.random.default_rng(0)
        toks = rng.integers(0, 3, (3, 6)).astype(np.int32)
        seg = rng.integers(0, 3, (2, 5)).astype(np.int32)
        qv, kv = toks[:, :4] != 0, toks != 0
        np.testing.assert_array_equal(
            tmasks.make_padding_mask(_t(toks)).numpy(),
            np.asarray(jmasks.make_padding_mask(jnp.asarray(toks))),
        )
        np.testing.assert_array_equal(
            tmasks.make_attention_mask(_t(qv), _t(kv)).numpy(),
            np.asarray(jmasks.make_attention_mask(jnp.asarray(qv), jnp.asarray(kv))),
        )
        np.testing.assert_array_equal(
            tmasks.make_segment_mask(_t(seg), _t(seg)).numpy(),
            np.asarray(jmasks.make_segment_mask(jnp.asarray(seg), jnp.asarray(seg))),
        )
        a, b = tmasks.make_causal_mask(6), tmasks.make_padding_mask(_t(toks))
        np.testing.assert_array_equal(
            tmasks.combine_masks(a, None, b).numpy(),
            np.asarray(jmasks.combine_masks(
                jmasks.make_causal_mask(6), None,
                jmasks.make_padding_mask(jnp.asarray(toks)),
            )),
        )
        assert tmasks.combine_masks(None, None) is None

    @pytest.mark.parametrize("length,dim", [(200, 512), (17, 32), (5, 6)])
    def test_sinusoidal_table_bit_equal(self, length, dim):
        np.testing.assert_array_equal(
            t_sinusoidal(length, dim).numpy(),
            np.asarray(j_sinusoidal(length, dim)),
        )


def _qkv(rng, b, h, sq, sk, d):
    f = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    return f(b, h, sq, d), f(b, h, sk, d), f(b, h, sk, d)


class TestFlashAttentionPlain:
    """``flash_attention`` on CPU tensors (its plain version) against the
    Pallas ``_flash_kernel`` in interpret mode."""

    @pytest.mark.parametrize(
        "case",
        [
            dict(b=2, h=2, sq=67, sk=67, d=16, causal=True, valid=None),
            dict(b=2, h=2, sq=40, sk=40, d=8, causal=False, valid=(25, 40)),
            dict(b=2, h=2, sq=24, sk=24, d=8, causal=True, valid=(16, 24)),
            dict(b=1, h=2, sq=20, sk=150, d=8, causal=False, valid=None),
            dict(b=1, h=2, sq=4, sk=20, d=8, causal=True, valid=None),
            dict(b=2, h=2, sq=1, sk=19, d=64, causal=False, valid=(7, 19)),
            dict(b=2, h=3, sq=130, sk=260, d=16, causal=True, valid=(200, 260)),
        ],
        ids=["causal", "kv_valid", "causal+kv_valid", "cross_lengths",
             "rect_causal", "one_query_dh64", "multi_block"],
    )
    def test_matches_pallas_interpret(self, case):
        rng = np.random.default_rng(7)
        q, k, v = _qkv(rng, case["b"], case["h"], case["sq"], case["sk"], case["d"])
        valid = None
        if case["valid"] is not None:
            valid = np.arange(case["sk"])[None, :] < np.asarray(case["valid"])[:, None]
        want = jpallas.flash_attention(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
            causal=case["causal"],
            kv_valid=None if valid is None else jnp.asarray(valid),
            interpret=True,
        )
        got = hop.flash_attention(
            _t(q), _t(k), _t(v), causal=case["causal"],
            kv_valid=None if valid is None else _t(valid),
        )
        _close(got, want)

    def test_fully_masked_rows_are_zeros_like_pallas(self):
        rng = np.random.default_rng(3)
        q, k, v = _qkv(rng, 2, 2, 16, 16, 8)
        valid = np.stack([np.zeros(16, bool), np.ones(16, bool)])
        want = np.asarray(jpallas.flash_attention(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
            kv_valid=jnp.asarray(valid), interpret=True,
        ))
        got = hop.flash_attention(_t(q), _t(k), _t(v), kv_valid=_t(valid)).numpy()
        np.testing.assert_array_equal(got[0], 0.0)
        np.testing.assert_array_equal(want[0], 0.0)
        _close(got, want)

    def test_strided_head_views_match_contiguous(self):
        """The model hands head-split views of a fused projection."""
        rng = np.random.default_rng(4)
        fused = _t(rng.standard_normal((2, 9, 3 * 32)).astype(np.float32))
        q, k, v = (
            t.view(2, 9, 4, 8).transpose(1, 2) for t in fused.chunk(3, dim=-1)
        )
        got = hop.flash_attention(q, k, v, causal=True)
        want = hop.flash_attention(
            q.contiguous(), k.contiguous(), v.contiguous(), causal=True
        )
        torch.testing.assert_close(got, want, atol=0, rtol=0)

    def test_dense_mask_dispatch_matches_jax(self):
        rng = np.random.default_rng(5)
        q, k, v = _qkv(rng, 2, 2, 6, 6, 8)
        mask = rng.random((2, 1, 6, 6)) < 0.7
        mask[..., 0] = True
        want = jattn.dot_product_attention(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(mask),
            causal=True, use_pallas=False,
        )
        got = tattn.dot_product_attention(_t(q), _t(k), _t(v), _t(mask), causal=True)
        _close(got, want)

    def test_wrapper_counts_no_launch_on_cpu_and_checks_shapes(self):
        rng = np.random.default_rng(6)
        q, k, v = _qkv(rng, 1, 2, 4, 5, 8)
        before = dict(hop.LAUNCHES)
        hop.flash_attention(_t(q), _t(k), _t(v))
        assert hop.LAUNCHES == before  # plain calls are not launches
        with pytest.raises(ValueError, match="kv_valid"):
            hop.flash_attention(
                _t(q), _t(k), _t(v), kv_valid=torch.ones(1, 4, dtype=torch.bool)
            )


class TestRaggedPagedAttentionPlain:
    """``ragged_paged_attention`` on CPU tensors against the Pallas
    ``_ragged_paged_kernel`` in interpret mode and the JAX fallback."""

    R, H, DH, PAGE, P = 6, 2, 8, 4, 6

    def _setup(self, seed, *, share_prefix=False, head_dim=None):
        dh = head_dim or self.DH
        rng = np.random.default_rng(seed)
        d_model = self.H * dh
        num_pages = 1 + self.R * self.P
        k_pages = rng.standard_normal((num_pages, self.PAGE, d_model)).astype(np.float32)
        v_pages = rng.standard_normal((num_pages, self.PAGE, d_model)).astype(np.float32)
        # inactive, sub-page, exact page, mid-table, full, mid-table
        lengths = np.array(
            [0, 1, self.PAGE, 2 * self.PAGE + 3, self.P * self.PAGE, 9], np.int32
        )
        table = np.zeros((self.R, self.P), np.int32)
        nxt = 1
        for r in range(self.R):
            used = -(-int(lengths[r]) // self.PAGE)
            table[r, :used] = np.arange(nxt, nxt + used)
            nxt += used
        query = rng.standard_normal((self.R, self.H, dh)).astype(np.float32)
        if share_prefix:
            # Row 5 reads row 3's pages (a prefix-cache hit).
            table[5], lengths[5], query[5] = table[3], lengths[3], query[3]
        cur_k = rng.standard_normal((self.R, d_model)).astype(np.float32)
        cur_v = rng.standard_normal((self.R, d_model)).astype(np.float32)
        return dict(
            query=query, k_pages=k_pages, v_pages=v_pages, table=table,
            lengths=lengths, cur_k=cur_k, cur_v=cur_v,
        )

    @staticmethod
    def _quantize(pages, rng):
        scale = (np.abs(pages).max(axis=-1) / 127.0 + 1e-6).astype(np.float32)
        q = np.clip(np.round(pages / scale[..., None]), -127, 127).astype(np.int8)
        return q, scale

    def _run(self, x, *, int8, with_cur):
        kw_np = {}
        kp, vp = x["k_pages"], x["v_pages"]
        if int8:
            rng = np.random.default_rng(11)
            kp, kw_np["k_scale"] = self._quantize(kp, rng)
            vp, kw_np["v_scale"] = self._quantize(vp, rng)
        if with_cur:
            kw_np["cur_k"], kw_np["cur_v"] = x["cur_k"], x["cur_v"]
        args = (x["query"], kp, vp, x["table"], x["lengths"])
        jargs = [jnp.asarray(a) for a in args]
        jkw = {k: jnp.asarray(v) for k, v in kw_np.items()}
        kernel = jpallas.ragged_paged_attention_kernel(*jargs, **jkw, interpret=True)
        fallback = jattn.ragged_paged_attention(*jargs, **jkw, use_pallas=False)
        got = hop.ragged_paged_attention(
            *[_t(a) for a in args], **{k: _t(v) for k, v in kw_np.items()}
        )
        return got, kernel, fallback

    @pytest.mark.parametrize("int8", [False, True], ids=["fp32", "int8"])
    @pytest.mark.parametrize("with_cur", [False, True], ids=["no_cur", "cur"])
    def test_matches_pallas_interpret_and_fallback(self, int8, with_cur):
        x = self._setup(seed=int(int8) * 2 + int(with_cur))
        got, kernel, fallback = self._run(x, int8=int8, with_cur=with_cur)
        _close(got, kernel)
        _close(got, fallback)
        if not with_cur:
            np.testing.assert_array_equal(got.numpy()[0], 0.0)  # inactive row

    def test_shared_prefix_pages_give_identical_rows(self):
        x = self._setup(seed=9, share_prefix=True)
        got, kernel, _ = self._run(x, int8=False, with_cur=False)
        torch.testing.assert_close(got[5], got[3], atol=0, rtol=0)
        _close(got, kernel)

    def test_head_dim_64(self):
        x = self._setup(seed=10, head_dim=64)
        got, kernel, fallback = self._run(x, int8=True, with_cur=True)
        _close(got, kernel)
        _close(got, fallback)

    def test_argument_checks(self):
        x = self._setup(seed=12)
        args = [_t(x[k]) for k in ("query", "k_pages", "v_pages", "table", "lengths")]
        with pytest.raises(ValueError, match="together"):
            hop.ragged_paged_attention(*args, k_scale=torch.ones(1, 1))
        with pytest.raises(ValueError, match="together"):
            hop.ragged_paged_attention(*args, cur_k=_t(x["cur_k"]))
