"""The port's serving engine (tests/test_serve_engine.py on
``repro_torch.serve.engine``): ``generate`` reuses one decode step per
model, and the step cache stays bounded and clearable.  Also the
sampler: greedy ``argmax``, and a seeded draw when ``temperature > 0``."""
import pytest
import torch

from repro_torch.serve import engine


class _ToyModel:
    """Minimal prefill/decode pair exercising the generate driver without
    a real LM (decode adds the token id to a running cache sum)."""

    def __init__(self, vocab: int = 17):
        self.vocab = vocab

    def prefill(self, params, batch, max_len):
        toks = batch["tokens"]
        cache = toks.sum(dim=1, keepdim=True).float()
        return cache.repeat(1, self.vocab), cache

    def decode_step(self, params, tok, cache, pos):
        cache = cache + tok.float()
        return cache.repeat(1, self.vocab), cache


@pytest.fixture(autouse=True)
def _fresh_cache():
    engine.clear_decode_cache()
    yield
    engine.clear_decode_cache()


def _gen(model, n_new=3):
    batch = {"tokens": torch.arange(6, dtype=torch.int32).reshape(2, 3)}
    return engine.generate(model, {}, batch, max_len=8, n_new=n_new)


def test_generate_runs_toy_model():
    out = _gen(_ToyModel())
    assert out.tokens.shape == (2, 3)
    assert out.prefill_logits.shape == (2, 17)


def test_generate_does_not_rebuild_per_call(monkeypatch):
    builds = []
    real = engine.make_decode_step

    def counting(model):
        builds.append(model)
        return real(model)

    monkeypatch.setattr(engine, "make_decode_step", counting)
    model = _ToyModel()
    first = _gen(model)
    assert len(builds) == 1
    second = _gen(model, n_new=5)      # same model: cached step reused
    assert len(builds) == 1
    assert second.tokens.shape == (2, 5)
    other = _ToyModel()
    _gen(other)                        # new model: one new build
    assert builds == [model, other]
    engine.clear_decode_cache()
    _gen(model)                        # cleared: rebuilds once
    assert builds == [model, other, model]
    assert first.tokens.shape == (2, 3)


def test_decode_cache_identity_and_boundedness():
    model = _ToyModel()
    fn = engine._decode_step_for(model)
    assert engine._decode_step_for(model) is fn
    keep = [_ToyModel() for _ in range(engine.STEP_CACHE_SIZE + 8)]
    for m in keep:
        engine._decode_step_for(m)
    assert len(engine._DECODE_CACHE) <= engine.STEP_CACHE_SIZE
    # the original model's entry was evicted by the flood -> fresh build
    assert engine._decode_step_for(model) is not fn


def test_sample_token_greedy_and_seeded():
    logits = torch.randn(4, 50, generator=torch.Generator().manual_seed(0))
    greedy = engine.sample_token(logits)
    assert greedy.dtype == torch.int32 and greedy.shape == (4, 1)
    assert torch.equal(greedy[:, 0].long(), logits.argmax(dim=-1))
    draws = [engine.sample_token(logits, torch.Generator().manual_seed(7),
                                 temperature=0.8) for _ in range(2)]
    assert torch.equal(draws[0], draws[1]) and draws[0].shape == (4, 1)
    assert bool(((draws[0] >= 0) & (draws[0] < 50)).all())
