"""The port's trainer (llama_cu_awq_torch/tools/train_tiny.py) held to the
JAX tool (tools/train_tiny.py) and optax on the CPU, at dim 64, 2 layers,
4 heads, seq 16 and batch 4.

Tolerances, and why:
- forward_loss: rel 1e-5. Both sum the same f32 products in their own
  order (XLA's dots against PyTorch's), a few ulps apart.
- gradients: rtol 1e-4, atol 1e-6 on every leaf (leaves reach about 0.07
  here): the same f32 sums in another order, through two backward passes.
- the schedule: rel 1e-6 and atol lr * 2**-21 (4 f32 ulps of the peak) at
  every step. optax evaluates it in f32, the port in Python's f64, and
  the warmup's 1 - count / warmup cancels f32's rounding into the small
  rates of its first steps.
- the clip: rtol 1e-6. The same f32 operations; the norm's sum runs in
  another order.
- 10 optimizer steps, and main() end to end: losses rel 1e-5; parameters
  atol 2e-6 (6e-4 * 10 steps of Adam; a step moves a parameter by up to
  the rate, and an update's ratio m / sqrt(v) differs by f32 rounding
  only, so parameters agree to a few ulps of their size).
- init_params: each leaf's sample std within 5 % of the JAX tool's formula
  (sampling error of at least 16k draws, under 1 %), mean within 3
  standard errors of 0, norms exactly 1. The two trainers draw from
  different generators: bit parity with jax.random is not the aim.
- export_awq and load_tokens: byte-equal and equal.
"""

import os
import re
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from llama_cu_awq_torch.config import ModelConfig as TModelConfig
from llama_cu_awq_torch.tokenizer import Tokenizer as TTokenizer
from llama_cu_awq_torch.tools import train_tiny as tt
from llama_cu_awq_torch.tools.make_test_model import write_byte_tokenizer
from llama_cu_awq_tpu.config import ModelConfig as JModelConfig
from llama_cu_awq_tpu.tokenizer import Tokenizer as JTokenizer
from tools import train_tiny as jt

torch.set_num_threads(1)

SHAPES = {"mha": dict(n_heads=4, n_kv_heads=4),
          "gqa": dict(n_heads=4, n_kv_heads=2)}
B, T = 4, 16
LOSS_REL = 1e-5
GRAD = dict(rtol=1e-4, atol=1e-6)
PARAM_ATOL = 2e-6

PROSE = (
    "The derivative of a function measures how its value changes as its "
    "input changes. For a function of one variable it is the slope of the "
    "tangent line at a point, and for a function of several variables the "
    "gradient collects the partial derivatives into one vector that points "
    "in the direction of steepest ascent. ",
    "To install the package, run the installer with the name of the "
    "release and check that the tests pass on your machine before you use "
    "it. The documentation lists every option, its default and the "
    "versions of the libraries it was built against. ",
    "Arrays hold elements of one type in a grid of any number of "
    "dimensions. Slicing an array returns a view that shares its memory, "
    "so writing to the view writes to the original; copy it first when "
    "the original must stay as it was. ",
)


def _cfgs(kind, vocab=300, **over):
    kw = dict(dim=64, hidden_dim=128, n_layers=2, vocab_size=vocab,
              seq_len=64, **SHAPES[kind])
    kw.update(over)
    return JModelConfig(**kw), TModelConfig(**kw)


def _host_params(cfg, seed=0):
    """Carried params: the port's init at `seed` in the npz layout."""
    g = torch.Generator()
    g.manual_seed(seed)
    return tt.params_to_numpy(tt.init_params(cfg, g))


def _jax_params(host):
    """The JAX tool's nested params from the npz layout."""
    n = sum(1 for k in host if k.endswith("_attn_norm"))
    return dict(embed=jnp.asarray(host["embed"]),
                lm_head=jnp.asarray(host["lm_head"]),
                final_norm=jnp.asarray(host["final_norm"]),
                layers=[{k: jnp.asarray(host[f"l{i}_{k}"])
                         for k in tt.LAYER_KEYS} for i in range(n)])


def _jax_flat(params):
    """The npz layout of JAX params (the JAX tool's main's savez)."""
    host = jax.tree.map(np.asarray, params)
    return {"embed": host["embed"], "lm_head": host["lm_head"],
            "final_norm": host["final_norm"],
            **{f"l{i}_{k}": v for i, l in enumerate(host["layers"])
               for k, v in l.items()}}


def _batch(seed, vocab):
    return np.random.default_rng(seed).integers(
        0, vocab, (B, T + 1)).astype(np.int32)


def _close_params(got, want, atol):
    assert list(got) == list(want)
    for name in want:
        np.testing.assert_allclose(got[name], want[name], rtol=0,
                                   atol=atol, err_msg=name)


@pytest.mark.parametrize("kind", ["mha", "gqa"])
def test_forward_loss_and_grads_match_jax(kind):
    jcfg, tcfg = _cfgs(kind)
    host = _host_params(tcfg)
    tokens = _batch(1, jcfg.vocab_size)
    j_loss, j_grads = jax.value_and_grad(jt.forward_loss)(
        _jax_params(host), jnp.asarray(tokens), jcfg)
    t_loss, t_grads = tt.loss_and_grads(tt.params_from_numpy(host),
                                        torch.from_numpy(tokens), tcfg)
    assert abs(float(t_loss) / float(j_loss) - 1) <= LOSS_REL
    want = _jax_flat(j_grads)
    assert list(want) == tt.leaf_names(tcfg.n_layers)
    for name, g in zip(want, t_grads):
        np.testing.assert_allclose(g.numpy(), want[name], **GRAD,
                                   err_msg=name)


@pytest.mark.parametrize("steps", [5, 50, 3000])
def test_schedule_matches_optax(steps):
    """optax's schedule as the JAX tool builds it (:233-235), at every
    update count up to a few past the end; steps < 10 has no warmup."""
    lr = 6e-4
    sched = optax.warmup_cosine_decay_schedule(
        0.0, lr, warmup_steps=min(200, steps // 10), decay_steps=steps,
        end_value=lr * 0.1)
    counts = np.arange(steps + 5)
    want = np.asarray(sched(jnp.asarray(counts, jnp.int32)), np.float64)
    got = np.array([tt.lr_at(int(c), lr, steps) for c in counts])
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=lr * 2.0 ** -21)
    assert got[0] == (lr if steps < 10 else 0.0)


@pytest.mark.parametrize("norm", [0.4, 1.0, 3.7])
def test_clip_matches_optax(norm):
    """Below the bound the gradients pass as they are; at and above it
    they are scaled to the bound."""
    rng = np.random.default_rng(2)
    grads = [rng.standard_normal(s).astype(np.float32)
             for s in ((7, 5), (11,), (3, 4, 2))]
    total = np.sqrt(sum(float((g.astype(np.float64) ** 2).sum())
                        for g in grads))
    grads = [(g * (norm / total)).astype(np.float32) for g in grads]
    want, _ = optax.clip_by_global_norm(1.0).update(
        [jnp.asarray(g) for g in grads], optax.EmptyState())
    got = tt.clip_by_global_norm([torch.from_numpy(g) for g in grads])
    for g, w, src in zip(got, want, grads):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6)
        if norm < 1.0:
            assert np.array_equal(g.numpy(), src)
    out = np.sqrt(sum(float((g.double() ** 2).sum()) for g in got))
    assert out == pytest.approx(min(norm, 1.0), rel=1e-5)


@pytest.mark.parametrize("kind", ["mha", "gqa"])
def test_ten_steps_match_optax(kind):
    """10 updates from the same params and batches: the port's clip,
    AdamW and schedule against the JAX tool's optax chain and jitted step
    (:233-244), with steps=10 (a warmup of one update at rate 0)."""
    jcfg, tcfg = _cfgs(kind)
    steps, lr = 10, 6e-4
    host = _host_params(tcfg, seed=4)
    batches = [_batch(10 + i, jcfg.vocab_size) for i in range(steps)]

    sched = optax.warmup_cosine_decay_schedule(
        0.0, lr, warmup_steps=min(200, steps // 10), decay_steps=steps,
        end_value=lr * 0.1)
    opt = optax.chain(optax.clip_by_global_norm(1.0),
                      optax.adamw(sched, b2=0.95, weight_decay=0.01))
    params = _jax_params(host)
    opt_state = opt.init(params)

    @jax.jit
    def train_step(params, opt_state, batch):
        loss, grads = jax.value_and_grad(jt.forward_loss)(params, batch,
                                                          jcfg)
        updates, opt_state = opt.update(grads, opt_state, params)
        return optax.apply_updates(params, updates), opt_state, loss

    j_losses = []
    for b in batches:
        params, opt_state, loss = train_step(params, opt_state,
                                             jnp.asarray(b))
        j_losses.append(float(loss))

    tp = tt.params_from_numpy(host)
    topt = tt.make_optimizer(tp)
    t_losses = [float(tt.train_step(tp, topt, torch.from_numpy(b), tcfg,
                                    tt.lr_at(i, lr, steps)))
                for i, b in enumerate(batches)]
    np.testing.assert_allclose(t_losses, j_losses, rtol=LOSS_REL)
    _close_params(tt.params_to_numpy(tp), _jax_flat(params), PARAM_ATOL)
    moved = max(float(np.abs(a - host[n]).max())
                for n, a in tt.params_to_numpy(tp).items())
    assert moved > 100 * PARAM_ATOL  # the bar is far below the change


def test_init_params_follow_the_jax_formula():
    """Each leaf's shape is the JAX tool's, and its spread is the JAX
    tool's formula: 0.02, 0.02 / sqrt(2L) where n_in is not dim, wo and
    w_down further divided by sqrt(2L)."""
    kw = dict(dim=128, hidden_dim=384, n_layers=3, n_heads=4, n_kv_heads=2,
              vocab_size=256, seq_len=64)
    jcfg, tcfg = JModelConfig(**kw), TModelConfig(**kw)
    want_shapes = {n: a.shape for n, a in _jax_flat(
        jt.init_params(jcfg, jax.random.PRNGKey(0))).items()}
    g = torch.Generator()
    g.manual_seed(0)
    params = tt.init_params(tcfg, g)
    assert all(p.requires_grad and p.dtype == torch.float32
               for p in tt.leaves(params))
    host = tt.params_to_numpy(params)
    assert {n: a.shape for n, a in host.items()} == want_shapes
    depth = np.sqrt(2 * tcfg.n_layers)
    for name, a in host.items():
        key = name.split("_", 1)[1] if name.startswith("l") and \
            name[1].isdigit() else name
        if key in ("attn_norm", "ffn_norm", "final_norm"):
            assert np.array_equal(a, np.ones_like(a))
            continue
        std = 0.02
        if key not in ("embed", "lm_head") and a.shape[0] != tcfg.dim:
            std /= depth
        if key in ("wo", "w_down"):
            std /= depth
        assert a.std() == pytest.approx(std, rel=0.05), name
        assert abs(a.mean()) < 3 * std / np.sqrt(a.size), name


def test_init_params_same_model_on_every_device():
    """The draws happen on the generator's device: a CPU generator gives
    the same model on any target device."""
    _, tcfg = _cfgs("gqa")
    a, b = torch.Generator(), torch.Generator()
    a.manual_seed(7)
    b.manual_seed(7)
    pa = tt.params_to_numpy(tt.init_params(tcfg, a))
    pb = tt.params_to_numpy(tt.init_params(tcfg, b, "cpu"))
    assert all(np.array_equal(pa[n], pb[n]) for n in pa)


@pytest.mark.parametrize("kind", ["mha", "gqa"])
def test_export_awq_is_byte_equal(tmp_path, kind):
    """Both tools' dumps of the same float params, file for file (a
    hidden width of 3 groups, a partial one in the GQA case)."""
    jcfg, tcfg = _cfgs(kind, hidden_dim=384 if kind == "mha" else 320)
    host = _host_params(tcfg, seed=5)
    jt.export_awq(jax.tree.map(np.asarray, _jax_params(host)), jcfg,
                  str(tmp_path / "jax"))
    tt.export_awq(host, tcfg, str(tmp_path / "torch"))
    names = sorted(os.listdir(tmp_path / "jax"))
    assert names == sorted(os.listdir(tmp_path / "torch"))
    assert len(names) == 3 + tcfg.n_layers * (7 * 3 + 2) + 1
    for n in names:
        assert (tmp_path / "jax" / n).read_bytes() == \
            (tmp_path / "torch" / n).read_bytes(), n


def _corpus(path, n_docs=24):
    """A tiny corpus in build_corpus's format: the prose above in n_docs
    documents."""
    os.makedirs(path, exist_ok=True)
    docs = [PROSE[i % 3] * (1 + i % 4) + f"Section {i}." for i in
            range(n_docs)]
    with open(os.path.join(path, "train.txt"), "w") as f:
        f.write("<|endoftext|>".join(docs[:-4]))
    with open(os.path.join(path, "valid.txt"), "w") as f:
        f.write("<|endoftext|>".join(docs[-4:]))
    return str(path)


@pytest.fixture(scope="module")
def byte_tok(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("tok") / "tok.bin")
    write_byte_tokenizer(path, 32000)
    return path


def test_load_tokens_match_jax(tmp_path, byte_tok):
    """The same ids, cached to the same file name and read back from the
    cache on the second call (a Llama-2 vocab and a byte tokenizer differ
    only in the ids)."""
    out = {}
    for name, mod, tok in (("jax", jt, JTokenizer(byte_tok, 32000)),
                           ("torch", tt, TTokenizer(byte_tok, 32000))):
        corpus = _corpus(tmp_path / name)
        first = {s: mod.load_tokens(corpus, s, tok) for s in ("train",
                                                              "valid")}
        assert sorted(f for f in os.listdir(corpus) if f.endswith(".npy")) \
            == ["train.tokens.npy", "valid.tokens.npy"]
        again = {s: mod.load_tokens(corpus, s, None) for s in first}
        assert all(np.array_equal(first[s], again[s]) for s in first)
        out[name] = first
    for s in ("train", "valid"):
        assert out["torch"][s].dtype == np.int32
        assert np.array_equal(out["torch"][s], out["jax"][s])


STEP_LINE = re.compile(r"^step (\d+): train loss (\d+\.\d{3}), valid loss "
                       r"(\d+\.\d{3}) \(ppl (\d+\.\d)\), \d+s$")


def _step_lines(err):
    lines = [m.groups() for m in map(STEP_LINE.match, err.splitlines()) if m]
    return [(int(s), float(a), float(b)) for s, a, b, _ in lines]


def test_main_matches_jax_end_to_end(tmp_path, byte_tok, monkeypatch,
                                     capsys):
    """Both main()s on the same tiny corpus with the byte tokenizer, from
    the same carried params (init_params patched on both sides): 12 steps
    (a log line at steps 0 and 11, 4 validation batches each, drawn
    between train batches), then float_params.npz within the bar, the
    same keys in the same order, the same dump files and config.json, and
    the same log lines."""
    argv = ["--tokenizer", byte_tok, "--dim", "64", "--hidden", "128",
            "--layers", "2", "--heads", "4", "--kv-heads", "2", "--seq",
            "16", "--batch", "4", "--steps", "12", "--lr", "1e-3"]
    _, tcfg = _cfgs("gqa", vocab=32000, seq_len=2048)
    host = _host_params(tcfg, seed=6)
    monkeypatch.setattr(jt, "init_params",
                        lambda cfg, key: _jax_params(host))
    monkeypatch.setattr(tt, "init_params",
                        lambda cfg, gen, dev: tt.params_from_numpy(host,
                                                                   dev))
    corpus = _corpus(tmp_path / "corpus")
    out = {}
    for name, run in (("jax", lambda a: (monkeypatch.setattr(
            sys, "argv", ["train_tiny.py", *a]), jt.main())[1]),
                      ("torch", lambda a: tt.main([*a, "--device", "cpu"]))):
        dest = str(tmp_path / name)
        assert run(["--corpus", corpus, "--out", dest, *argv]) == 0
        err = capsys.readouterr().err
        out[name] = (dict(np.load(os.path.join(dest, "float_params.npz"))),
                     sorted(os.listdir(os.path.join(dest, "awq"))),
                     open(os.path.join(dest, "awq", "config.json")).read(),
                     _step_lines(err), err)
    j, t = out["jax"], out["torch"]
    _close_params(t[0], j[0], PARAM_ATOL)
    assert list(t[0]) == tt.leaf_names(2)
    assert t[1] == j[1] and t[2] == j[2]
    assert [s for s, *_ in t[3]] == [s for s, *_ in j[3]] == [0, 11]
    for (_, ta, tv), (_, ja, jv) in zip(t[3], j[3]):
        assert ta == pytest.approx(ja, abs=1.5e-3)  # printed to 3 places
        assert tv == pytest.approx(jv, abs=1.5e-3)
    assert "M params, " in t[4] and "M train tokens on cpu" in t[4]
    assert "exported AWQ dump to " in t[4]


def test_main_runs_on_cuda_by_default(monkeypatch, tmp_path, byte_tok):
    """Without --device the trainer asks for the card, and raises where
    there is none."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA was requested"):
        tt.main(["--corpus", _corpus(tmp_path / "c"), "--out",
                 str(tmp_path / "o"), "--tokenizer", byte_tok])
