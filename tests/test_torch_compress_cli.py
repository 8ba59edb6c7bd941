"""The port's Table-1 CLI (``repro_torch.launch.compress``) on the CPU at
a small size, against the reference's ``repro.launch.compress``.

The two train from different initial weights and noise (torch generators
against jax keys) on the same digits and the same numpy batches, so they
are held to each other's rates, not bytes. At these settings (400
steps, 512 training digits, 64 images at 8 lanes) the two land within
about 1% of each other on seeds 0 and 1; the tolerances below, 2% for
the -ELBO and 3% for the wire, leave room for the noise of other
draws."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.data import synthetic_mnist as ref_mnist  # noqa: E402
from repro.launch import compress as ref_cli  # noqa: E402
from repro_torch import shard_codec  # noqa: E402
from repro_torch.data import baselines, synthetic_mnist  # noqa: E402
from repro_torch.launch import compress as cli  # noqa: E402

STEPS, N_TRAIN, IMAGES, LANES = 400, 512, 64, 8


@pytest.mark.parametrize("split,n,seed", [("train", 300, 0),
                                          ("test", 257, 123)])
def test_synthetic_digits_equal_the_reference(split, n, seed):
    """The port's own copy of the digit renderer (which renders in chunks
    of 128 images) and binarization give the reference's arrays."""
    imgs, labels = synthetic_mnist.load(split, n, seed)
    want, want_labels = ref_mnist.load(split, n, seed)
    np.testing.assert_array_equal(imgs, want)
    np.testing.assert_array_equal(labels, want_labels)
    np.testing.assert_array_equal(synthetic_mnist.binarize(imgs, seed),
                                  ref_mnist.binarize(want, seed))


def test_cli_matches_the_reference_rates_and_passes_its_gate():
    with jax.threefry_partitionable(False):
        make_ref, _, elbo_ref = ref_cli.train_dataset_model(
            "vae-bernoulli", steps=STEPS, seed=0, n_train=N_TRAIN)
        imgs_ref, data_ref, _ = ref_cli.load_corpus("vae-bernoulli",
                                                    IMAGES, LANES)
        blob_ref = ref_cli.compress_corpus(make_ref(), data_ref, n_shards=1,
                                           block_symbols=32, seed=0)
    make, binary, elbo = cli.train_dataset_model(
        "vae-bernoulli", steps=STEPS, seed=0, n_train=N_TRAIN, device="cpu")
    imgs, data, _ = cli.load_corpus("vae-bernoulli", IMAGES, LANES,
                                    device="cpu")
    np.testing.assert_array_equal(imgs, imgs_ref)
    np.testing.assert_array_equal(data.numpy(), np.asarray(data_ref))
    codec = make()
    blob = cli.compress_corpus(codec, data, n_shards=1, block_symbols=32,
                               seed=0, device="cpu")
    back = shard_codec.decompress_dataset(codec, blob, devices=["cpu"],
                                          compile=True)
    assert torch.equal(back, data)
    bpd, bpd_ref = len(blob) * 8 / imgs.size, len(blob_ref) * 8 / imgs.size
    assert elbo == pytest.approx(elbo_ref, rel=0.02)
    assert bpd == pytest.approx(bpd_ref, rel=0.03)
    # The CLI's own gate: BB-ANS below gzip and bz2.
    rates = baselines.baseline_rates(imgs, binary, with_png=True)
    assert bpd < rates["gzip"] and bpd < rates["bz2"]


def test_two_shards_on_one_device_decode():
    """``compress_corpus`` over 2 shards on one device: a BBX3 corpus of
    two segments of 2 lanes each, decoded losslessly."""
    make, _, _ = cli.train_dataset_model("vae-bernoulli", steps=2, seed=1,
                                         n_train=16, device="cpu")
    _, data, _ = cli.load_corpus("vae-bernoulli", 4, 4, device="cpu")
    codec = make()
    blob = cli.compress_corpus(codec, data, n_shards=2, block_symbols=2,
                               seed=4, device="cpu")
    info = shard_codec.corpus_info(blob)
    assert info["n_shards"] == 2 and info["lanes_per_shard"] == 2
    back = shard_codec.decompress_dataset(codec, blob,
                                          devices=["cpu", "cpu"])
    assert torch.equal(back, data)


HVAE_STEPS, HVAE_TRAIN = 100, 256


def test_hvae_small2_trains_near_the_reference_and_its_corpus_decodes():
    """``--arch hvae-small2``: after 100 steps on the 128 digits
    ``n_train=256`` leaves it, the port's -ELBO is within 3% of the
    reference CLI's (different initial weights and noise; 1.2% and 0.8%
    apart on seeds 0 and 1), and its Bit-Swap codec compresses a 2-shard
    corpus of 28 x 28 digits that decodes losslessly."""
    with jax.threefry_partitionable(False):
        _, _, elbo_ref = ref_cli.train_dataset_model(
            "hvae-small2", steps=HVAE_STEPS, seed=0, n_train=HVAE_TRAIN)
    make, binary, elbo = cli.train_dataset_model(
        "hvae-small2", steps=HVAE_STEPS, seed=0, n_train=HVAE_TRAIN,
        device="cpu")
    assert binary and np.isfinite(elbo)
    assert elbo == pytest.approx(elbo_ref, rel=0.03)
    imgs, data, _ = cli.load_corpus("hvae-small2", 2, 2, device="cpu")
    imgs_ref, data_ref, _ = ref_cli.load_corpus("hvae-small2", 2, 2)
    np.testing.assert_array_equal(imgs, imgs_ref)
    np.testing.assert_array_equal(data.numpy(), np.asarray(data_ref))
    assert data.shape == (1, 2, 28, 28)
    codec = make()
    # 512 clean chunks a block: the first posterior pop of a 28 x 28 image
    # (392 latents) needs more than the default 32 and 128, which the
    # stream would reach by re-encoding twice.
    blob = cli.compress_corpus(codec, data, n_shards=2, block_symbols=1,
                               seed=0, init_chunks=512, device="cpu")
    assert shard_codec.corpus_info(blob)["n_shards"] == 2
    back = shard_codec.decompress_dataset(codec, blob,
                                          devices=["cpu", "cpu"])
    assert torch.equal(back, data)


@pytest.mark.parametrize("arch,item", [("vae-beta_binomial", "item 3")])
def test_unported_archs_name_their_roadmap_items(arch, item):
    with pytest.raises(NotImplementedError, match=item):
        cli.train_dataset_model(arch, steps=1, device="cpu")
    with pytest.raises(NotImplementedError, match=item):
        cli.load_corpus(arch, 8, 8, device="cpu")


def test_cli_needs_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(["--images", "8", "--lanes", "8", "--train-steps", "1"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.train_dataset_model("vae-bernoulli", steps=1)
