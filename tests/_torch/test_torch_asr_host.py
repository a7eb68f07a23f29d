"""The CTC probe's host code in the port (``blvm_tpu_torch/data``, ``utils/decoding.py``,
``evaluation/metrics.py``, ``experiments/asr_ctc.py``'s features and padding) against the JAX
package's copies of the same code, on numpy inputs made from seeds: equal outputs (the spectrogram
within 1e-6)."""

import numpy as np
import pytest

from blvm_tpu.data import batchers as jax_batchers
from blvm_tpu.data import token_map as jax_token_map
from blvm_tpu.data import tokens as jax_tokens
from blvm_tpu.data import transforms as jax_transforms
from blvm_tpu.data.buckets import BucketSpec as JaxBucketSpec
from blvm_tpu.data.text_cleaners import clean_timit as jax_clean_timit
from blvm_tpu.data.tokenizers import char_tokenizer as jax_char_tokenizer
from blvm_tpu.data.tokenizers import word_tokenizer as jax_word_tokenizer
from blvm_tpu.evaluation import metrics as jax_metrics
from blvm_tpu.parallel.mesh import pad_batch_to_devices
from blvm_tpu.utils import decoding as jax_decoding
from blvm_tpu_torch.data import batchers, tokens, transforms
from blvm_tpu_torch.data.buckets import BucketSpec, bucket_length
from blvm_tpu_torch.data.text_cleaners import clean_timit
from blvm_tpu_torch.data.token_map import TokenMap
from blvm_tpu_torch.data.tokenizers import char_tokenizer, word_tokenizer
from blvm_tpu_torch.evaluation.metrics import ErrorRateMetric, edit_distance, edit_distances
from blvm_tpu_torch.experiments import asr_ctc
from blvm_tpu_torch.utils import decoding

PHN = "0 2400 h#\n2400 3360 sh\n3360 4533 ix\n4533 5840 hv\n5840 7000 eh\n7000 8400 dcl\n8400 9280 jh\n9280 12000 h#\n"
TXT = "0 46797 She had your dark suit in greasy wash water; all \"year\": Don't.\n"


def _texts(n, rng):
    """TIMIT-like phone transcripts: numbered lines of phones, h# at both ends."""
    phones = [p for p in tokens.TIMIT_PHONESET if p not in ("1", "2")]
    out = []
    for _ in range(n):
        seq = ["h#"] + list(rng.choice(phones, rng.integers(0, 30))) + ["h#"]
        out.append("".join(f"{i * 100} {(i + 1) * 100} {p}\n" for i, p in enumerate(seq)))
    return out


def test_token_sets_and_token_map_equal_jax():
    assert tokens.TIMIT_PHONESET == jax_tokens.TIMIT_PHONESET and tokens.TIMIT_ALPHABET == jax_tokens.TIMIT_ALPHABET
    assert (tokens.BLANK_TOKEN, tokens.UNKNOWN_TOKEN) == (jax_tokens.BLANK_TOKEN, jax_tokens.UNKNOWN_TOKEN)
    for alphabet, kwargs in ((tokens.TIMIT_PHONESET, dict(add_blank=True)),
                             (tokens.TIMIT_ALPHABET, dict(add_blank=True, add_unknown=True)),
                             (tokens.ENGLISH_STANDARD, dict(add_start=True, add_end=True))):
        ours, theirs = TokenMap(list(alphabet), **kwargs), jax_token_map.TokenMap(list(alphabet), **kwargs)
        assert ours.tokens == theirs.tokens and ours.token2index == theirs.token2index and len(ours) == len(theirs)
        seq = list(alphabet[:5]) + list(alphabet[-3:])
        assert ours.encode(seq) == theirs.encode(seq)
        ids = np.asarray(ours.encode(seq))
        assert ours.decode(ids, " ") == theirs.decode(ids, " ") and ours.decode(ids) == theirs.decode(ids)
        batch, lens = np.stack([ids, ids[::-1]]), np.asarray([8, 3])
        assert ours.decode_batch(batch, lens, " ") == theirs.decode_batch(batch, lens, " ")
    assert len(asr_ctc.build_token_map(asr_ctc.build_args([]))) == 65


@pytest.mark.parametrize("text", [PHN, TXT, "", "0 1 h#\n"], ids=["phn", "txt", "empty", "only_h"])
def test_cleaner_and_tokenizers_equal_jax(text):
    assert clean_timit(text) == jax_clean_timit(text)
    cleaned = clean_timit(text)
    assert word_tokenizer(cleaned) == jax_word_tokenizer(cleaned)
    assert char_tokenizer(cleaned) == jax_char_tokenizer(cleaned)


def test_spectrogram_and_stacking_equal_jax():
    rng = np.random.default_rng(0)
    wave = (0.1 * rng.standard_normal(4321)).astype(np.float32)
    ours = transforms.LogMelSpectrogram(sample_rate=16000, n_fft=512, win_length=128, hop_length=64, n_mels=80)
    theirs = jax_transforms.LogMelSpectrogram(sample_rate=16000, n_fft=512, win_length=128, hop_length=64, n_mels=80)
    np.testing.assert_array_equal(transforms.mel_filterbank(16000, 512, 80), jax_transforms.mel_filterbank(16000, 512, 80))
    got, ref = ours(wave), theirs(wave)
    assert got.shape == ref.shape == (80, 1 + 4321 // 64)
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-6)
    for n in (64, 4321):
        np.testing.assert_array_equal(transforms.StackTensor(64)(wave[:n]), jax_transforms.StackTensor(64)(wave[:n]))


def test_encoded_examples_and_padding_equal_the_jax_driver():
    """``encode_example`` as the JAX driver's modalities (``experiment_asr_ctc.py:build_modalities``)
    and ``make_batch`` as its batchers and ``make_batch`` (``:112-135``, ``:258-268``), with a row
    added for ``--accum_steps 2``."""
    rng = np.random.default_rng(1)
    waves = [(0.1 * rng.standard_normal(n)).astype(np.float32) for n in (3000, 1234, 2049)]
    texts = _texts(3, rng)
    jax_map = jax_token_map.TokenMap(tokens=list(jax_tokens.TIMIT_PHONESET), add_blank=True)
    jax_text = jax_transforms.Compose(jax_transforms.TextCleaner(jax_clean_timit, lambda s: s.replace("h#", "").strip()),
                                      jax_transforms.EncodeInteger(token_map=jax_map, tokenizer=jax_word_tokenizer))
    for data_type in ("spectrogram", "waveform"):
        args = asr_ctc.build_args(["--data_type", data_type, "--accum_steps", "2"])
        token_map = asr_ctc.build_token_map(args)
        examples = [asr_ctc.encode_example(w, t, args, token_map) for w, t in zip(waves, texts)]
        if data_type == "spectrogram":
            jax_feats = [jax_transforms.LogMelSpectrogram(16000, 512, 128, 64, 80)(w).T for w in waves]
        else:
            jax_feats = [jax_transforms.StackTensor(64)(w) for w in waves]
        for (f, labels), jf, t in zip(examples, jax_feats, texts):
            assert f.dtype == np.float32 and f.shape == jf.shape
            np.testing.assert_allclose(f, jf, rtol=0, atol=1e-6)
            assert labels == jax_text(t)
        batch = asr_ctc.make_batch(examples, args)
        x, x_sl = jax_batchers.DynamicTensorBatcher(axis=0, bucket=JaxBucketSpec(mode="multiple", multiple=64))(
            [f for f, _ in examples])
        y, y_sl = jax_batchers.TextBatcher(bucket=JaxBucketSpec(mode="multiple", multiple=16))(
            [labels for _, labels in examples])
        x, x_sl = pad_batch_to_devices(np.asarray(x, np.float32), np.asarray(x_sl), 2)
        y, y_sl = pad_batch_to_devices(np.asarray(y), np.asarray(y_sl), 2)
        for key, ref in dict(x=x, x_sl=x_sl, y=y, y_sl=y_sl).items():
            assert batch[key].shape == ref.shape and batch[key].dtype == ref.dtype, key
            np.testing.assert_array_equal(batch[key], ref, err_msg=key)
        assert batch["x"].shape[0] == 4 and batch["x"].shape[1] % 64 == 0 and batch["y"].shape[1] % 16 == 0
    rep = rng.standard_normal((37, 12)).astype(np.float32)
    args = asr_ctc.build_args(["--data_type", "wavenet-z0-n1.npy"])
    feats, _ = asr_ctc.encode_example(rep, texts[0], args, asr_ctc.build_token_map(args))
    np.testing.assert_array_equal(feats, rep)
    for n in (0, 1, 64, 65, 1000):
        assert bucket_length(n, BucketSpec(multiple=64)) == jax_batchers.bucket_length(n, JaxBucketSpec(multiple=64))


def test_batchers_equal_jax_with_batch_size_buckets():
    rng = np.random.default_rng(2)
    arrays = [rng.standard_normal((n, 3)).astype(np.float32) for n in (5, 17, 9)]
    kw = dict(axis=0, bucket=None, batch_size_bucket=None)
    for bucket, rows in ((BucketSpec(multiple=8), BucketSpec(multiple=4)), (BucketSpec(mode="pow2", base=4), None)):
        jb = JaxBucketSpec(mode=bucket.mode, multiple=bucket.multiple, base=bucket.base)
        jr = None if rows is None else JaxBucketSpec(multiple=rows.multiple)
        got = batchers.DynamicTensorBatcher(**{**kw, "bucket": bucket, "batch_size_bucket": rows})(arrays)
        ref = jax_batchers.DynamicTensorBatcher(**{**kw, "bucket": jb, "batch_size_bucket": jr})(arrays)
        for a, b in zip(got, ref):
            np.testing.assert_array_equal(a, b)
    labels = [list(rng.integers(1, 65, n)) for n in (3, 0, 7)]
    for a, b in zip(batchers.TextBatcher(bucket=BucketSpec(multiple=16))(labels),
                    jax_batchers.TextBatcher(bucket=JaxBucketSpec(multiple=16))(labels)):
        np.testing.assert_array_equal(a, b)


def test_greedy_decoders_equal_jax():
    rng = np.random.default_rng(3)
    logits = rng.standard_normal((5, 30, 6))
    logits[1, :, 2] += 3.0  # long runs of one label, collapsed
    lens = np.asarray([30, 17, 2, 1, 29])
    assert decoding.greedy_ctc(logits, lens, blank=0) == jax_decoding.greedy_ctc(logits, lens, blank=0)
    assert decoding.greedy_ctc(logits, lens, blank=2) == jax_decoding.greedy_ctc(logits, lens, blank=2)
    assert decoding.greedy_standard(logits, lens) == jax_decoding.greedy_standard(logits, lens)
    # a row of length 0 decodes to nothing (the JAX copy raises an IndexError there)
    assert decoding.greedy_ctc(logits, np.asarray([30, 0, 2, 1, 29]))[1] == []


def test_edit_distances_and_error_rates_equal_jax():
    """The row-vectorised DP against the JAX package's two-row Python DP: random integer sequences
    (empty ones too), and WER and CER over decoded phone strings."""
    rng = np.random.default_rng(4)
    refs = [list(rng.integers(0, 6, rng.integers(0, 25))) for _ in range(200)]
    hyps = [list(rng.integers(0, 6, rng.integers(0, 25))) for _ in range(200)]
    assert edit_distances(refs, hyps).tolist() == [jax_metrics.edit_distance(r, h) for r, h in zip(refs, hyps)]
    assert edit_distance("kitten", "sitting") == 3 == jax_metrics.edit_distance("kitten", "sitting")
    assert edit_distances([], []).shape == (0,)
    token_map = TokenMap(list(tokens.TIMIT_PHONESET), add_blank=True)
    ids = [rng.integers(1, 65, rng.integers(1, 40)) for _ in range(40)]
    ref_txt = [token_map.decode(i, " ") for i in ids]
    hyp_txt = [token_map.decode(i[rng.random(len(i)) < 0.8], " ") for i in ids]
    for tokenizer, jax_tokenizer in ((word_tokenizer, jax_word_tokenizer), (char_tokenizer, jax_char_tokenizer)):
        ours = ErrorRateMetric(ref_txt[:20], hyp_txt[:20], tokenizer, name="er")
        theirs = jax_metrics.ErrorRateMetric(ref_txt[:20], hyp_txt[:20], jax_tokenizer, name="er")
        ours.update(ErrorRateMetric(ref_txt[20:], hyp_txt[20:], tokenizer, name="er"))
        theirs.update(jax_metrics.ErrorRateMetric(ref_txt[20:], hyp_txt[20:], jax_tokenizer, name="er"))
        assert (ours._edits, ours._len, ours.value) == (theirs._edits, theirs._len, theirs.value)
