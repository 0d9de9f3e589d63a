"""The port's token pipeline (``data/pipeline.py`` on its own threefry,
``data/_threefry.py``) against the reference's ``TokenPipeline``.

* The installed jax's PRNG implementation is threefry2x32 with
  ``jax_threefry_partitionable`` on, which the port mirrors; the test
  asserts that.  The port draws as the reference does without
  ``jax_enable_x64`` (its train CLI's mode; under x64 its gate takes 0.5
  as an f64 and draws 64-bit uniforms), so the comparisons run with x64
  off (tests/conftest.py turns it on).
* Exact: keys, ``fold_in``, ``split``, ``bits``, ``uniform`` and
  ``bernoulli`` bit for bit; ``batch_at``'s tokens, labels and mask over
  several steps and shards at V 241 and at qwen3_4b's V 151936 (a small
  batch).
* ``prefix_embeds`` and ``enc_embeds`` (standard normals through
  ``erfinv``) within 64 f32 ulps or 1e-6 absolute (torch's ``erfinv``
  against XLA's polynomial; the largest gap seen is 38 ulps, on values
  near zero).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.data.pipeline import DataConfig as J_DataConfig  # noqa: E402
from repro.data.pipeline import TokenPipeline as J_Pipeline  # noqa: E402

from repro_torch.data import DataConfig, TokenPipeline  # noqa: E402
from repro_torch.data import _threefry as R  # noqa: E402

CPU = "cpu"
ULPS = 64
ATOL = 1e-6


def test_the_mirrored_prng_settings():
    assert jax.config.jax_threefry_partitionable is True
    assert jax.config.jax_default_prng_impl == "threefry2x32"
    assert jax.config.jax_enable_x64 is True  # tests/conftest.py


def _words(k):
    return tuple(int(x) for x in np.asarray(jax.random.key_data(k)))


@pytest.mark.parametrize("seed", (0, 1, 12345, 2**40 + 7))
def test_keys_fold_in_and_split_bitwise(seed):
    kj, kt = jax.random.key(seed), R.key(seed)
    assert _words(kj) == kt
    for data in (0, 1, 7, 2**31 + 5):
        kj2, kt2 = jax.random.fold_in(kj, data), R.fold_in(kt, data)
        assert _words(kj2) == tuple(kt2)
        assert [_words(k) for k in jax.random.split(kj2, 4)] == \
            [tuple(k) for k in R.split(kt2, 4)]


@pytest.mark.parametrize("shape", ((7,), (3, 5), (2, 3, 64)))
def test_bits_uniform_and_bernoulli_bitwise(shape):
    kj = jax.random.fold_in(jax.random.key(3), 11)
    kt = R.fold_in(R.key(3), 11)
    bits = np.asarray(jax.random.bits(kj, shape, jnp.uint32)).astype(
        np.int64).ravel()
    assert np.array_equal(bits, R.bits(kt, shape, device=CPU).numpy())
    for lo, hi in ((0.0, 1.0), (-3.5, 2.25)):
        u = np.asarray(jax.random.uniform(kj, shape, jnp.float32, lo,
                                          hi)).ravel()
        assert np.array_equal(u, R.uniform(kt, shape, lo, hi,
                                           device=CPU).numpy())
    for p in (0.5, 0.1):
        b = np.asarray(jax.random.bernoulli(kj, jnp.float32(p), shape))
        assert np.array_equal(b, R.bernoulli(kt, p, shape,
                                             device=CPU).numpy())


def _embeds_close(a, b):
    a = np.asarray(a, np.float32)
    b = b.numpy()
    ulps = np.abs(a.view(np.int32).astype(np.int64)
                  - b.view(np.int32).astype(np.int64))
    assert np.all((ulps <= ULPS) | (np.abs(a - b) <= ATOL)), ulps.max()


@pytest.mark.parametrize("seed", (0, 3))
@pytest.mark.parametrize("vocab,batch,seq,steps", ((241, 4, 32, 4),
                                                   (151936, 1, 8, 2)))
def test_batch_at_equals_the_reference(seed, vocab, batch, seq, steps):
    cfg = dict(vocab_size=vocab, seq_len=seq, global_batch=batch, seed=seed,
               num_prefix_tokens=3, enc_len=5, d_model=16)
    with jax.enable_x64(False):
        ref = J_Pipeline(J_DataConfig(**cfg))
        port = TokenPipeline(DataConfig(**cfg), device=CPU)
        shards = ((0, 1), (1, 2)) if batch % 2 == 0 else ((0, 1),)
        for step in range(steps):
            for shard, n in shards:
                a, b = ref.batch_at(step, shard, n), port.batch_at(step, shard,
                                                                   n)
                assert set(a) == set(b)
                for k in ("tokens", "labels", "loss_mask"):
                    assert np.array_equal(np.asarray(a[k]), b[k].numpy()), k
                    assert str(b[k].dtype).endswith(
                        str(np.asarray(a[k]).dtype))
                for k in ("prefix_embeds", "enc_embeds"):
                    _embeds_close(a[k], b[k])


def test_categorical_streams_the_gumbel_block():
    """Row blocks smaller than one row's noise give the same draws."""
    logits = torch.from_numpy(np.log(np.arange(1, 301) / 45150.0)
                              .astype(np.float32))
    k = R.fold_in(R.key(5), 2)
    whole = R.categorical(k, logits, (3, 7))
    assert torch.equal(R.categorical(k, logits, (3, 7), block_elems=1),
                       whole)
    want = np.asarray(jax.random.categorical(
        jax.random.fold_in(jax.random.key(5), 2), jnp.asarray(logits.numpy()),
        shape=(3, 7)))
    assert np.array_equal(whole.numpy(), want)


def test_iterate_and_default_device():
    import inspect

    assert inspect.signature(TokenPipeline).parameters["device"].default \
        == "cuda"
    port = TokenPipeline(DataConfig(vocab_size=50, seq_len=4, global_batch=2),
                         device=CPU)
    it = port.iterate(start_step=3)
    for step in (3, 4):
        b = next(it)
        assert torch.equal(b["tokens"], port.batch_at(step)["tokens"])
        assert b["tokens"].device.type == "cpu"
