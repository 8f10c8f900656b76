"""The port's eval harness (``repro_torch.eval``) and
``Engine.score_continuations`` against the JAX package, on the CPU.

The synthetic tasks are JAX's item for item; scores of the same sequences
through the port's engine are within ``SCORE_TOL`` (relative to the
largest |score|) of JAX's, float and under a policy (the frameworks sum
the float matmuls and the log-softmax in other orders; packed runs
quantize the same activations, and a last-bit difference upstream can move
one across an FP8 rounding edge, which these seeds do not); a row scored
alone equals the same row in a batch within ``BATCH_TOL`` absolute (JAX's
own bound: the batch shares one per-tensor input scale); the gold labels
and the decided subset are JAX's."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
from _torch_threads import jax_compile_cache  # noqa: E402,F401  (test-process settings)

import jax  # noqa: E402

from repro import eval as JEV  # noqa: E402
from repro.configs import smoke_config as jax_smoke_config  # noqa: E402
from repro.eval import harness as JH  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.policy import DSBPPolicy as JaxPolicy  # noqa: E402
from repro.serve.engine import Engine as JaxEngine  # noqa: E402
from repro.serve.engine import ServeConfig as JaxServeConfig  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch import eval as TEV  # noqa: E402
from repro_torch.configs import smoke_config  # noqa: E402
from repro_torch.eval import harness as TH  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402
from repro_torch.policy import DSBPPolicy  # noqa: E402
from repro_torch.serve.engine import Engine, ServeConfig  # noqa: E402
from test_torch_model import np_tree  # noqa: E402

SCORE_TOL = 1e-4
BATCH_TOL = 1e-5
KEYS = sorted(f"units/0/{sub}/{n}" for sub, ns in (("attn", ("wq", "wk", "wv", "wo")),
                                                   ("ffn", ("w1", "w2", "w3"))) for n in ns)


@pytest.fixture(scope="module")
def pair():
    jcfg = jax_smoke_config("yi-9b").replace(dtype="float32", remat=False)
    params = JM.init(jax.random.PRNGKey(0), jcfg)
    cfg = smoke_config("yi-9b")
    return jcfg, params, cfg, lambda: bridge.model_from_jax(np_tree(params), cfg, device="cpu")


def _items(task):
    return [(i.context, i.choices) for i in task.items]


@pytest.mark.parametrize("seed", [7, 11])
def test_task_generators_deterministic_and_equal_jax(seed):
    a = TEV.boolq_synthetic(512, 8, seed=seed)
    b = TEV.boolq_synthetic(512, 8, seed=seed)
    assert a.items == b.items
    w1 = TEV.winogrande_synthetic(512, 8, seed=seed)
    w2 = TEV.winogrande_synthetic(512, 8, seed=seed)
    assert w1.items == w2.items
    assert all(it.choices[0] != it.choices[1] for it in w1.items)
    sl = w1.meta["suffix_len"]
    assert all(it.choices[0][-sl:] == it.choices[1][-sl:] for it in w1.items)
    assert _items(a) == _items(JEV.boolq_synthetic(512, 8, seed=seed))
    assert _items(w1) == _items(JEV.winogrande_synthetic(512, 8, seed=seed))
    assert a.meta == JEV.boolq_synthetic(512, 8, seed=seed).meta
    assert w1.meta == JEV.winogrande_synthetic(512, 8, seed=seed).meta
    sub = a.subset([1, 3])
    assert _items(sub) == _items(JEV.boolq_synthetic(512, 8, seed=seed).subset([1, 3]))
    for s, p in a.items[0].sequences():
        assert s.dtype == np.int64 and p == len(a.items[0].context)


def _seqs(vocab, seed=5):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, (n,)) for n in (9, 4, 13, 6, 17)], [5, 2, 9, 3, 16]


@pytest.mark.parametrize("kind", ["float", "policy"])
def test_score_continuations_match_jax(pair, kind):
    jcfg, params, cfg, fresh = pair
    seqs, plens = _seqs(cfg.vocab_size)
    if kind == "float":
        jeng = JH.float_engine(params, jcfg, max_len=64)
        eng = TH.float_engine(fresh(), cfg, max_len=64)
    else:
        jpol = JaxPolicy(layers={k: ("precise", "efficient")[i % 2]
                                 for i, k in enumerate(KEYS)})
        jeng = JaxEngine(params, jcfg, JaxServeConfig(max_len=64, pack_preset=jpol,
                                                      quant_method="dsbp_ref"))
        eng = Engine(fresh(), ServeConfig(max_len=64, pack_preset=DSBPPolicy.from_json(
            jpol.to_json())), device="cpu")
    j = np.asarray(jeng.score_continuations(seqs, plens))
    t = eng.score_continuations(seqs, plens)
    assert t.dtype == np.float32 and t.shape == (5,)
    assert np.abs(t - j).max() <= SCORE_TOL * np.abs(j).max(), (t, j)
    with pytest.raises(ValueError, match="continuation token"):
        eng.score_continuations([seqs[0]], [len(seqs[0])])


def test_score_continuations_batch_invariant(pair):
    _, _, cfg, fresh = pair
    pol = DSBPPolicy.uniform("precise", KEYS)
    eng = Engine(fresh(), ServeConfig(max_len=64, pack_preset=pol), device="cpu")
    seqs, plens = _seqs(cfg.vocab_size)
    batched = eng.score_continuations(seqs[:4], plens[:4])
    solo = np.concatenate([eng.score_continuations([s], [p])
                           for s, p in zip(seqs[:4], plens[:4])])
    np.testing.assert_allclose(batched, solo, rtol=0, atol=BATCH_TOL)


def test_gold_labels_and_decided_subset(pair):
    jcfg, params, cfg, fresh = pair
    model = fresh()
    task = TEV.boolq_synthetic(cfg.vocab_size, 12, seed=3)
    gold, margins = TH.gold_labels_and_margins(model, cfg, task)
    gold2, margins2 = TH.gold_labels_and_margins(model, cfg, task)
    np.testing.assert_array_equal(gold, gold2)
    np.testing.assert_array_equal(margins, margins2)
    assert margins.min() >= 0
    jgold, jmargins = JH.gold_labels_and_margins(
        params, jcfg, JEV.boolq_synthetic(jcfg.vocab_size, 12, seed=3))
    np.testing.assert_array_equal(gold, jgold)
    np.testing.assert_allclose(margins, jmargins, rtol=0,
                               atol=SCORE_TOL * np.abs(jmargins).max())
    med = float(np.median(jmargins))
    sub, gsub = TH.decided_subset(task, gold, margins, med)
    jsub, jgsub = JH.decided_subset(JEV.boolq_synthetic(jcfg.vocab_size, 12, seed=3),
                                    jgold, jmargins, med)
    assert _items(sub) == _items(jsub)
    np.testing.assert_array_equal(gsub, jgsub)
    assert 0 < len(sub.items) <= len(task.items) and len(gsub) == len(sub.items)
    acc = TH.evaluate(TH.float_engine(model, cfg), sub, gsub)
    assert acc == 1.0
    hard = TH.hard_subset(task, margins, 0.5)
    assert _items(hard) == _items(JH.hard_subset(
        JEV.boolq_synthetic(jcfg.vocab_size, 12, seed=3), jmargins, 0.5))
    with pytest.raises(ValueError, match="no items"):
        TH.decided_subset(task, gold, margins, float(margins.max()) + 1)
    # the float engine ran on a view: the model is neither packed nor moved
    assert all(not hasattr(m, "ka") for m in model.modules())


def test_decided_tasks_equal_jax(pair):
    jcfg, params, cfg, fresh = pair
    tasks, golds = TH.decided_tasks(fresh(), cfg, 16)
    jtasks, jgolds = JH.decided_tasks(params, jcfg, 16)
    assert [t.name for t in tasks] == [t.name for t in jtasks]
    for t, jt, g, jg in zip(tasks, jtasks, golds, jgolds):
        assert _items(t) == _items(jt) and t.meta == jt.meta
        np.testing.assert_array_equal(g, jg)


def test_float_engine_shares_the_model(pair):
    _, _, cfg, fresh = pair
    model = fresh()
    eng = TH.float_engine(model, cfg.replace(quant="precise"))
    assert eng.cfg.quant is None and eng.pack_report is None
    assert eng.model is not model and eng.model.embed is model.embed
    assert TM.shared(model).layers[1].ffn.w2 is model.layers[1].ffn.w2


def test_score_row_alone_equals_it_among_copies(pair):
    """Under a mixed policy (fixed- and dsbp-mode configs) a row scored
    alone equals it in a batch of its own copies bit for bit: no result for
    a row depends on the batch's size.  Against a batch of other rows the
    scores may move (at full width, chip_smoke.py phase 17): every
    projection's input path takes one per-tensor scale over all the rows of
    its GEMM, JAX's semantics too."""
    _, _, cfg, fresh = pair
    pol = DSBPPolicy(layers={k: ("precise", "efficient", "e5m7_fixed", "e5m3_fixed")[i % 4]
                             for i, k in enumerate(KEYS)})
    eng = Engine(fresh(), ServeConfig(max_len=64, pack_preset=pol), device="cpu")
    seqs, plens = _seqs(cfg.vocab_size, seed=9)
    for s, p in zip(seqs, plens):
        alone = eng.score_continuations([s], [p])
        np.testing.assert_array_equal(eng.score_continuations([s] * 3, [p] * 3),
                                      np.repeat(alone, 3))
