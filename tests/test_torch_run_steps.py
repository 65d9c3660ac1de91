"""``Executor.run_steps``: k training steps in one call, equal bit for bit
to k sequential ``run()`` calls, on the CPU.

* The reference's own cases (``tests/test_pipelined_exec.py``: parity
  with k sequential runs at k = 1 and 4, Adam on an MLP, every
  persistable and the step counter bit for bit; the stacked-feed errors:
  an unstacked feed, a mismatched k, k inferred from the feeds, no feed
  without k, k < 1), imported and run as they are with the names they
  import pointed at the port.
* ERNIE-tiny with dropout and AdamW from one state: k = 4 steps of
  ``run_steps`` equal 4 ``run()`` calls bit for bit (every loss, every
  dropout mask, every parameter and moment, the step counter), from a
  fresh key (the first two steps as ``run()`` takes them, the rest
  replayed by ``run_many``) and from a key whose step is already built;
  then run_steps and run() alternate.
* word2vec's sparse program: the fetched SelectedRows gradient stacks
  per step, equal to the sequential fetches.
* The span ``executor.run_steps`` and the timer ``executor.run_steps_ms``
  (one sample a call, the name the tuner and the scaler read); a program
  holding a host-IO op raises (A9).
"""

import types

import numpy as np
import pytest
import torch

import paddle_tpu_torch as ptt
from paddle_tpu_torch import layers as players
from paddle_tpu_torch import optimizer as popt
from paddle_tpu_torch.core import telemetry
from paddle_tpu_torch.core import unique_name as pt_names
from paddle_tpu_torch.core.executor import (STEP_COUNTER, ExecutionError,
                                            Executor)
from paddle_tpu_torch.core.ir import OpDesc
from paddle_tpu_torch.core.selected_rows import SelectedRows
from paddle_tpu_torch.models import bert as pbert
from paddle_tpu_torch.models import word2vec as pw2v

import tests.test_pipelined_exec as ref_cases

torch.set_num_threads(2)


def _port_scope_copy(src):
    dst = ptt.Scope()
    for n, v in list(src.items()):
        dst.set(n, v.clone() if isinstance(v, torch.Tensor) else v)
    return dst


@pytest.fixture
def port_in_reference(monkeypatch):
    """Point the names the reference's run_steps cases use at the port:
    its Program, layers, optimizers, a CPU Executor, Scope and
    ExecutionError, and a scope copy of tensors."""
    port = types.SimpleNamespace(
        Program=ptt.Program, program_guard=ptt.program_guard,
        optimizer=popt, Scope=ptt.Scope,
        Executor=lambda *a, **kw: Executor(device="cpu"))
    monkeypatch.setattr(ref_cases, "pt", port)
    monkeypatch.setattr(ref_cases, "layers", players)
    monkeypatch.setattr(ref_cases, "ExecutionError", ExecutionError)
    monkeypatch.setattr(ref_cases, "_clone_scope", _port_scope_copy)


RUN_STEPS_CASES = [
    ("TestFusedParity", "test_bitwise_parity_vs_sequential", {"k": 1}),
    ("TestFusedParity", "test_bitwise_parity_vs_sequential", {"k": 4}),
    ("TestStackedFeedValidation", "test_unstacked_feed_raises", {}),
    ("TestStackedFeedValidation", "test_mismatched_k_raises", {}),
    ("TestStackedFeedValidation", "test_k_inferred_from_feed", {}),
    ("TestStackedFeedValidation", "test_no_feed_needs_explicit_k", {}),
    ("TestStackedFeedValidation", "test_bad_k_raises", {}),
]


@pytest.mark.parametrize("cls,name,kw", RUN_STEPS_CASES,
                         ids=[f"{c}.{n}{kw.get('k', '')}"
                              for c, n, kw in RUN_STEPS_CASES])
def test_reference_case_on_the_port(port_in_reference, cls, name, kw):
    getattr(getattr(ref_cases, cls)(), name)(**kw)


# ---------------------------------------------------------------------------
# ERNIE-tiny with dropout
# ---------------------------------------------------------------------------

ERNIE = dict(vocab_size=128, hidden_size=64, num_hidden_layers=2,
             num_attention_heads=2, intermediate_size=128,
             max_position_embeddings=64, type_vocab_size=2)
K = 4


def _ernie():
    cfg = pbert.BertConfig(use_flash_attention=True, **ERNIE)
    with pt_names.guard():
        main, startup, _, fetches = pbert.build_pretraining_program(
            cfg, seq_len=32, optimizer_name="adamw",
            max_predictions_per_seq=4)
    batches = [pbert.synthetic_pretraining_batch(
        cfg, 2, 32, seed=i, max_predictions_per_seq=4) for i in range(K)]
    masks = [o.outputs["Mask"][0] for o in main.global_block().ops
             if o.type == "dropout"]
    return main, startup, batches, [fetches["loss"].name] + masks


def _state_equal(a, b):
    names = sorted(n for n, v in a.items() if isinstance(v, torch.Tensor))
    assert names
    for n in names:
        assert torch.equal(a.find_var(n), b.find_var(n)), n
    assert int(a.find_var(STEP_COUNTER)) == int(b.find_var(STEP_COUNTER))


@pytest.mark.parametrize("warm", [False, True])
def test_run_steps_equals_k_runs_bitwise(warm):
    main, startup, batches, fetch = _ernie()
    exe = Executor(device="cpu")
    seq = ptt.Scope()
    exe.run(startup, scope=seq)
    fused = _port_scope_copy(seq)
    if warm:      # the key's step built before run_steps: all k replayed
        for scope in (seq, fused):
            for b in batches[:2]:
                exe.run(main, feed=b, fetch_list=fetch, scope=scope)
    want = [exe.run(main, feed=b, fetch_list=fetch, scope=seq)
            for b in batches]
    stacked = {n: np.stack([b[n] for b in batches]) for n in batches[0]}
    got = exe.run_steps(main, feed=stacked, fetch_list=fetch, scope=fused)
    assert len(got) == len(fetch)
    for j, g in enumerate(got):
        assert g.shape[0] == K
        for i in range(K):
            assert np.array_equal(g[i], want[i][j]), (fetch[j], i)
    assert not np.array_equal(got[1][0], got[1][1])     # fresh masks
    _state_equal(seq, fused)
    # and on: run() and run_steps() alternate from the same state
    a = exe.run(main, feed=batches[0], fetch_list=fetch, scope=seq)
    b = exe.run_steps(main, feed={n: v[:1] for n, v in stacked.items()},
                      fetch_list=fetch, scope=fused)
    for x, y in zip(a, b):
        assert np.array_equal(x, y[0])
    _state_equal(seq, fused)


def test_run_steps_without_numpy_gives_stacked_tensors():
    main, startup, batches, fetch = _ernie()
    exe, scope = Executor(device="cpu"), ptt.Scope()
    exe.run(startup, scope=scope)
    step = int(scope.find_var(STEP_COUNTER))
    stacked = {n: np.stack([b[n] for b in batches]) for n in batches[0]}
    out = exe.run_steps(main, feed=stacked, fetch_list=fetch[:1], k=K,
                        scope=scope, return_numpy=False)
    assert isinstance(out[0], torch.Tensor) and out[0].shape[0] == K
    assert int(scope.find_var(STEP_COUNTER)) == step + K


def test_sparse_gradient_fetch_stacks_per_step():
    with pt_names.guard():
        main, startup, _, fetches = pw2v.build_word2vec_program(
            50, 6, lr=0.5)
    exe = Executor(device="cpu")
    seq = ptt.Scope()
    exe.run(startup, scope=seq)
    fused = _port_scope_copy(seq)
    batches = [pw2v.synthetic_batch(50, 6, seed=i) for i in range(3)]
    fetch = [fetches["loss"].name, "shared_w@GRAD"]
    want = [exe.run(main, feed=b, fetch_list=fetch, scope=seq)
            for b in batches]
    got = exe.run_steps(main, feed={n: np.stack([b[n] for b in batches])
                                    for n in batches[0]},
                        fetch_list=fetch, scope=fused)
    assert isinstance(got[1], SelectedRows)
    assert got[1].rows.shape == (3, 24) and got[1].values.shape == (3, 24, 32)
    for i, w in enumerate(want):
        assert np.array_equal(got[0][i], w[0])
        assert np.array_equal(got[1].rows[i], w[1].rows)
        assert np.array_equal(got[1].values[i], w[1].values)
    _state_equal(seq, fused)


def test_span_timer_and_the_host_io_check():
    with pt_names.guard():
        main, startup = ptt.Program(), ptt.Program()
        with ptt.program_guard(main, startup):
            x = players.data("x", [8])
            loss = players.mean(players.fc(x, 4))
            popt.SGDOptimizer(0.1).minimize(loss)
    exe, scope = Executor(device="cpu"), ptt.Scope()
    exe.run(startup, scope=scope)
    before = telemetry.snapshot()["hists"].get(
        "executor.run_steps_ms", {}).get("count", 0)
    exe.run_steps(main, feed={"x": np.ones((3, 2, 8), np.float32)},
                  fetch_list=[loss], scope=scope)
    hist = telemetry.snapshot()["hists"]["executor.run_steps_ms"]
    assert hist["count"] == before + 1
    main.global_block().ops.append(OpDesc("send", {}, {}, {}))
    with pytest.raises(NotImplementedError, match="A9"):
        exe.run_steps(main, feed={"x": np.ones((3, 2, 8), np.float32)},
                      fetch_list=[loss], scope=scope)
