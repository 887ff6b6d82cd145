"""The port's data modules (``repro_torch/data/{pipeline,synthetic,
tokenizer}.py``) against ``repro``'s: numpy in, numpy out, so every
comparison is bit for bit (values, dtypes, shapes and the cursor)."""
import numpy as np
import pytest

pytest.importorskip("jax")

from repro.data import pipeline as JP  # noqa: E402
from repro.data import synthetic as JS  # noqa: E402
from repro.data import tokenizer as JT  # noqa: E402
from repro_torch.data import pipeline as TP  # noqa: E402
from repro_torch.data import synthetic as TS  # noqa: E402
from repro_torch.data import tokenizer as TT  # noqa: E402


def _same(got, want):
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("vocab,seed", [(256, 0), (50_304, 3), (5, 7)])
def test_markov_corpus_is_repros(vocab, seed):
    _same(TS.markov_corpus(4096, vocab, seed=seed),
          JS.markov_corpus(4096, vocab, seed=seed))


def test_copy_task_batch_is_repros():
    for seq in (9, 16):
        _same(TS.copy_task_batch(np.random.default_rng(1), 3, seq, 50),
              JS.copy_task_batch(np.random.default_rng(1), 3, seq, 50))


def test_byte_tokenizer_is_repros():
    text = "lakehouse ✓ commits\n"
    tok, ref = TT.ByteTokenizer(), JT.ByteTokenizer()
    for kw in ({}, {"add_bos": False}, {"add_eos": False}):
        _same(tok.encode(text, **kw), ref.encode(text, **kw))
    ids = ref.encode(text)
    assert tok.decode(ids) == ref.decode(ids) == text
    assert tok.spec() == ref.spec()


@pytest.mark.parametrize("batch,seq,shard", [(4, 32, 256), (3, 17, 40),
                                             (8, 64, 1024)])
def test_pipeline_batches_and_cursor_are_repros(batch, seq, shard):
    """Every batch across two epochs and the cursor after each, and a
    pipeline resumed from a saved state."""
    tokens = JS.markov_corpus(batch * (seq + 1) * 12, 256, seed=2)
    mine = TP.DataPipeline(TP.TokenDataset(tokens, shard), batch=batch,
                           seq_len=seq, seed=5)
    ref = JP.DataPipeline(JP.TokenDataset(tokens, shard), batch=batch,
                          seq_len=seq, seed=5)
    epochs = set()
    for _ in range(30):
        for got, want in zip(mine.next_batch(), ref.next_batch()):
            _same(got, want)
        assert mine.state.to_json() == ref.state.to_json()
        epochs.add(mine.state.epoch)
    assert len(epochs) > 1                      # the cursor wrapped
    resumed = TP.DataPipeline(TP.TokenDataset(tokens, shard), batch=batch,
                              seq_len=seq, state=TP.PipelineState.from_json(
                                  ref.state.to_json()))
    for got, want in zip(resumed.next_batch(), ref.next_batch()):
        _same(got, want)


def test_lease_queue_matches_repros():
    """The same acquire/complete script on both queues, with a lease
    expiring, gives the same answers."""
    clocks = [{"t": 0.0}, {"t": 0.0}]
    queues = [TP.ShardLeaseQueue(4, lease_seconds=10.0,
                                 clock=lambda: clocks[0]["t"]),
              JP.ShardLeaseQueue(4, lease_seconds=10.0,
                                 clock=lambda: clocks[1]["t"])]
    script = [("acquire", "a"), ("acquire", "slow"), ("acquire", "a"),
              ("complete", "a", 0), ("acquire", "a"), ("complete", "a", 2),
              ("acquire", "a"), ("tick", 11.0), ("acquire", "a"),
              ("complete", "a", 1), ("complete", "slow", 1),
              ("complete", "a", 3), ("acquire", "a"), ("complete", "a", 3),
              ("acquire", "a")]
    for step in script:
        answers = []
        for q, clock in zip(queues, clocks):
            if step[0] == "tick":
                clock["t"] = step[1]
                answers.append(None)
            elif step[0] == "acquire":
                answers.append(q.acquire(step[1]))
            else:
                answers.append(q.complete(step[1], step[2]))
        assert answers[0] == answers[1], step
        assert queues[0].finished == queues[1].finished
    assert queues[0].finished
