"""The port's down->next-qkv chain against the JAX package, on the CPU.

ops/cuda/down_qkv.py's plain version (what a CPU tensor takes) against
the JAX Pallas kernel `down_qkv_fused` in interpret mode on inputs made
from a seed with numpy, with tests/test_down_qkv.py's shapes and
tolerance; against the port's own standalone pair, bit for bit; its
`supported` gate; and a whole forward with LLAMA_TPU_DOWN_QKV=1 against
the JAX forward under the same switch, each side counting its chain
calls. The kernel itself runs in tests/test_torch_cuda.py on the card.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llama_cu_awq_torch.models import llama as tl
from llama_cu_awq_torch.ops.cuda import down_qkv as tdq
from llama_cu_awq_torch.ops.linear import qmatmul_fused as t_qmatmul_fused
from llama_cu_awq_torch.ops.norms import RMS_EPS
from llama_cu_awq_torch.quant.qtensor import QTensor as TQ
from llama_cu_awq_tpu.config import ModelConfig
from llama_cu_awq_tpu.io.checkpoint import random_checkpoint
from llama_cu_awq_tpu.models import llama as jl
from llama_cu_awq_tpu.ops.pallas import down_qkv as jdq
from llama_cu_awq_tpu.quant import packing
from llama_cu_awq_tpu.quant.qtensor import QTensor as JQ
from llama_cu_awq_tpu.quant.qtensor import to_tpu_layout

# one intra-op thread per process: the suite runs in several worker
# processes, and torch's default pool in each oversubscribes the cores
torch.set_num_threads(1)


def _qtensors(rng, n_in, n_out):
    """The same quantized weight for both packages (the JAX one in the
    TPU kernel's planar layout)."""
    w = rng.normal(size=(n_in, n_out)).astype(np.float32) * 0.05
    qw, zeros, scales = packing.quantize_np(w)
    j = JQ(jnp.asarray(qw), jnp.asarray(zeros), jnp.asarray(scales), n_in,
           n_out)
    return to_tpu_layout(j), TQ.from_numpy(qw, zeros, scales, n_in)


def _bf16(a):
    """numpy f32 -> (jax bf16 array, torch bf16 tensor) with equal bits."""
    j = jnp.asarray(a, jnp.bfloat16)
    return j, torch.from_numpy(np.array(j, np.float32)).bfloat16()


def _inputs(rng, m, dim, hid):
    g = _bf16(rng.normal(size=(m, hid)).astype(np.float32) * 0.5)
    u = _bf16(rng.normal(size=(m, hid)).astype(np.float32) * 0.5)
    res = _bf16(rng.normal(size=(m, dim)).astype(np.float32))
    nw = rng.normal(size=(dim,)).astype(np.float32)
    return g, u, res, nw


@pytest.mark.parametrize("m,dim,hid,qkv_out", [
    (1, 1024, 1536, 1536),
    (4, 1024, 1536, 1536),
    (1, 1024, 1024, 1024),
    (8, 1024, 1536, 1536),
])
def test_plain_matches_jax_kernel(rng, m, dim, hid, qkv_out):
    """tests/test_down_qkv.py:20-54's shapes and bars: the JAX kernel keeps
    its scales in bf16 (packing.build_meta) and sums in another order."""
    jd, td = _qtensors(rng, hid, dim)
    jq, tq = _qtensors(rng, dim, qkv_out)
    (gj, gt), (uj, ut), (rj, rt), nw = _inputs(rng, m, dim, hid)
    want_x2, want_ss, want_qkv = jdq.down_qkv_fused(
        gj, uj, rj, jd, jq, jnp.asarray(nw), eps=RMS_EPS,
        out_dtype=jnp.bfloat16, interpret=True)
    got_x2, got_ss, got_qkv = tdq.down_qkv_fused(
        gt, ut, rt, td, tq, torch.from_numpy(nw), eps=RMS_EPS)
    assert got_x2.dtype == torch.bfloat16 and got_qkv.dtype == torch.float32
    assert got_ss.shape == (m, 1) and got_qkv.shape == (m, qkv_out)
    np.testing.assert_allclose(got_x2.float().numpy(),
                               np.asarray(want_x2, np.float32),
                               rtol=2e-2, atol=2e-2)
    np.testing.assert_allclose(got_ss.numpy(), np.asarray(want_ss),
                               rtol=1e-2, atol=1e-4)
    np.testing.assert_allclose(got_qkv.numpy(), np.asarray(want_qkv),
                               rtol=2e-2, atol=2e-2)


@pytest.mark.parametrize("out_dtype", [torch.bfloat16, torch.float32])
def test_plain_equals_standalone_pair(rng, out_dtype):
    """The chain is the pair it replaces: int4_matmul_fused with the SwiGLU
    prologue, residual and rms scale, then with the rmsnorm prologue."""
    m, dim, hid, n_q = 3, 256, 384, 512
    _, td = _qtensors(rng, hid, dim)
    _, tq = _qtensors(rng, dim, n_q)
    (_, gt), (_, ut), (_, rt), nw = _inputs(rng, m, dim, hid)
    nw = torch.from_numpy(nw)
    x2, ss2, qkv = tdq.down_qkv_fused(gt, ut, rt, td, tq, nw, eps=RMS_EPS,
                                      out_dtype=out_dtype)
    px2, pss2 = t_qmatmul_fused(gt, td, silu_u=ut, residual=rt,
                                emit_ss_eps=RMS_EPS)
    pq, _ = t_qmatmul_fused(px2, tq, prescale=(pss2, nw),
                            out_dtype=out_dtype)
    assert torch.equal(x2, px2) and torch.equal(ss2, pss2)
    assert torch.equal(qkv, pq)


def test_supported_gate(rng):
    """The port kernel's own limit (not the TPU's VMEM arithmetic): down's
    output is qkv's input, both input widths a multiple of 32, any m."""
    _, td = _qtensors(rng, 384, 256)
    _, tq = _qtensors(rng, 256, 512)
    assert tdq.supported(td, tq, 1)
    assert tdq.supported(td, tq, 10_000)  # further passes, no VMEM bound
    assert not tdq.supported(td, tq, 0)
    _, tq_other = _qtensors(rng, 288, 512)
    assert not tdq.supported(td, tq_other, 1)  # 256 != 288
    _, td_odd = _qtensors(rng, 400, 256)
    assert not tdq.supported(td_odd, tq, 1)  # 400 % 32 != 0
    # 512-wide rows chain here, where the JAX gate refuses them
    # (tests/test_down_qkv.py:90-94): the chain computes the pair exactly
    _, td512 = _qtensors(rng, 1536, 512)
    _, tq512 = _qtensors(rng, 512, 768)
    assert tdq.supported(td512, tq512, 1)


CHAIN_CFG = ModelConfig(dim=1024, hidden_dim=1536, n_layers=3, n_heads=8,
                        n_kv_heads=8, vocab_size=512, seq_len=128)
STEPS = [5, 42, 300]


def test_forward_chain_matches_jax(monkeypatch):
    """Three T=1 fused_step steps with LLAMA_TPU_DOWN_QKV=1 on both sides:
    the JAX forward with tpu-layout params and its Pallas kernels in
    interpret mode, the port's forward on the plain versions. The chain
    runs twice a step on each side (layers 0->1 and 1->2). Logits within
    2 % of the largest (the JAX kernels' bf16 scales) and the same argmax;
    the port's logits equal its standalone path's bit for bit."""
    cfg = CHAIN_CFG
    ckpt = random_checkpoint(cfg, seed=11)
    jp = jl.params_from_checkpoint(ckpt, param_dtype=jnp.bfloat16,
                                   tpu_layout=True)
    jp_canon = jl.params_from_checkpoint(ckpt, param_dtype=jnp.bfloat16)
    tp = tl.params_from_numpy(jax.tree_util.tree_map(np.asarray, jp_canon),
                              cfg, device="cpu")
    calls = {"jax": 0, "torch": 0}

    def counted(side, fn):
        def wrapped(*a, **k):
            calls[side] += 1
            return fn(*a, **k)
        return wrapped

    monkeypatch.setattr(jdq, "down_qkv_fused",
                        counted("jax", jdq.down_qkv_fused))
    monkeypatch.setattr(tdq, "down_qkv_fused",
                        counted("torch", tdq.down_qkv_fused))

    def run_torch():
        tc = tl.init_kv_cache(cfg, 1, 128, device="cpu")
        out = []
        for step, t in enumerate(STEPS):
            lg, tc = tl.forward(tp, cfg, torch.tensor([[t]]),
                                torch.tensor([step], dtype=torch.int32), tc,
                                attn_impl="fused_step")
            out.append(lg.numpy())
        return np.stack(out)

    monkeypatch.setenv("LLAMA_TPU_DOWN_QKV", "1")
    jc = jl.init_kv_cache(cfg, 1, 128)
    want = []
    for step, t in enumerate(STEPS):
        lg, jc = jl.forward(jp, cfg, jnp.asarray([[t]], jnp.int32),
                            jnp.asarray([step], jnp.int32), jc,
                            matmul_impl="pallas", attn_impl="fused_step")
        want.append(np.asarray(lg))
    want = np.stack(want)
    got = run_torch()
    assert calls == {"jax": 2 * len(STEPS), "torch": 2 * len(STEPS)}
    tol = 2e-2 * max(1.0, float(np.abs(want).max()))
    assert float(np.abs(got - want).max()) <= tol
    assert (got.argmax(-1) == want.argmax(-1)).all()

    monkeypatch.setenv("LLAMA_TPU_DOWN_QKV", "0")
    assert np.array_equal(run_torch(), got)
    assert calls["torch"] == 2 * len(STEPS)  # no chain without the switch
