"""The rest of the port's data and utility layer against grain and the JAX
package on the CPU.

* ``data/grain_loader.py``: the epoch order against grain's own
  ``IndexSampler`` (and its compiled ``index_shuffle``) at 1, 10 and 1,000
  records and one past 2**16, and at a power of two, where grain's order
  repeats a record; the ``--grain`` batches against the JAX package's
  ``make_grain_loader`` on the same PNG tree (indices and items, flips off;
  the ``uid`` key dropped); the flips drawn from (seed, epoch, batch); a
  resumed ``cli.train_diffusion --grain`` run equal to an unbroken one.
* ``data/prefetch.py``: order, values, laziness (``size`` items pulled
  before the first batch, one more a batch), iterators shorter than
  ``size``, the refusal of ``mesh=``.
* ``utils/profiling.py``: ``trace`` writes a trace file that holds an
  ``annotate`` region.
* ``MSIvsMSSDataset`` and ``CheXpertDataset`` against the JAX package's
  classes, items and labels, on a PNG tree and a label CSV written here (an
  empty Cardiomegaly cell among them).
"""

import json

import numpy as np
import pytest
import torch

from medfusion_tpu.data import datasets_2d as jax_ds
from medfusion_tpu.data.grain_loader import make_grain_loader
from medfusion_tpu_torch.cli import presets, train_diffusion
from medfusion_tpu_torch.data import datasets_2d as ds
from medfusion_tpu_torch.data import png
from medfusion_tpu_torch.data.grain_loader import (
    GrainDataModule,
    grain_order,
    index_shuffle,
    seed_seq_words,
)
from medfusion_tpu_torch.data.prefetch import prefetch_to_device
from medfusion_tpu_torch.utils import checkpoint as C
from medfusion_tpu_torch.utils import profiling
from tests.test_torch_checkpoint import _equal_trees, image_preset  # noqa: F401  (a fixture)
from tests.test_torch_data import _image, write_chexpert_2


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ---- grain's order ---------------------------------------------------------------


def _sampler_keys(n, seed):
    import grain.python as pg

    sampler = pg.IndexSampler(num_records=n, shuffle=True, seed=seed, num_epochs=1,
                              shard_options=pg.ShardByJaxProcess(drop_remainder=True))
    return [sampler[i].record_key for i in range(n)]


@pytest.mark.parametrize("n,seed", [(1, 0), (10, 3), (1000, 123), (48, 0), (65537, 7),
                                    (65537, 2**32 - 1)])
def test_grain_order_equals_grains_index_sampler(n, seed):
    assert grain_order(n, seed).tolist() == _sampler_keys(n, seed)


def test_index_shuffle_equals_grains_module_and_its_power_of_two_repeat():
    from grain._src.python.experimental.index_shuffle.python import index_shuffle_module

    for max_index in (9, 255, 65535, 65536, 69999):
        for seed in (0, 12345):
            idx = np.arange(0, max_index + 1, max(1, max_index // 300))
            want = [index_shuffle_module.index_shuffle(int(i), max_index=max_index,
                                                       seed=seed, rounds=4) for i in idx]
            assert index_shuffle(idx, max_index, seed).tolist() == want
            assert index_shuffle(int(idx[1]), max_index, seed) == want[1]
    # at max_index = 2**16 the last position holds position 0's record again
    last = index_shuffle_module.index_shuffle(65536, max_index=65536, seed=5, rounds=4)
    assert index_shuffle(65536, 65536, 5) == index_shuffle(0, 65536, 5) == last
    with pytest.raises(ValueError, match="2\\*\\*32"):
        index_shuffle(0, 9, 2**32)


def test_the_walk_one_value_at_a_time_equals_the_whole_domains(monkeypatch):
    """Past 2**22 values the walks run one encryption at a time; at 70,000
    records (a domain of 2**18) both routes give grain's order."""
    from medfusion_tpu_torch.data import grain_loader

    whole = grain_order(70_000, 11)
    monkeypatch.setattr(grain_loader, "_WHOLE_DOMAIN", 1 << 16)
    assert np.array_equal(grain_order(70_000, 11), whole)
    assert sorted(whole.tolist()) == list(range(70_000))


def test_seed_seq_words_are_cpps():
    """``std::seed_seq{s}.generate`` of 4 words (libstdc++), for s = 0, 3."""
    assert seed_seq_words(0, 4) == [2963817213, 69796629, 1973464570, 532167439]
    assert seed_seq_words(3, 4) == [124996394, 1357073493, 2789781637, 3712642085]


class _Indexed:
    """A dataset whose items also carry their index."""

    def __init__(self, base):
        self.base = base

    def __len__(self):
        return len(self.base)

    def __getitem__(self, i):
        return {**self.base[i], "index": np.int64(i)}


def _colon_tree(root, n=10):
    for k in range(n):
        cls = ("MSIMUT", "MSS")[k % 2]
        (root / cls).mkdir(parents=True, exist_ok=True)
        png.write_png(root / cls / f"tile{k:02d}.png", _image(12, 10 + k % 3, 3, seed=k))
    return root


FLIPS_OFF = dict(image_resize=8, image_crop=8)


@pytest.mark.parametrize("seed", [0, 5])
def test_grain_batches_equal_jax_make_grain_loader(tmp_path, seed):
    root = _colon_tree(tmp_path / "colon")
    port = _Indexed(ds.MSIvsMSSDataset(root, crawler_ext="png", **FLIPS_OFF))
    ref = _Indexed(jax_ds.MSIvsMSSDataset(root, crawler_ext="png", **FLIPS_OFF))
    dm = GrainDataModule(port, batch_size=3, seed=seed)
    assert dm.batches_per_epoch() == 3
    for epoch in (0, 1):
        got = list(dm.train_dataloader(epoch))
        want = list(make_grain_loader(ref, 3, seed=seed + epoch, num_epochs=1))
        assert len(got) == len(want) == 3
        for a, b in zip(got, want):
            assert set(a) == set(b) == {"index", "source", "target"}
            for k in a:
                np.testing.assert_array_equal(a[k], np.asarray(b[k]), err_msg=k)
        order = grain_order(10, seed + epoch)[:9].tolist()
        assert [int(i) for b in got for i in b["index"]] == order


def test_grain_flips_come_from_seed_epoch_and_batch(tmp_path):
    root = _colon_tree(tmp_path / "colon")
    flips = dict(FLIPS_OFF, augment_horizontal_flip=True, augment_vertical_flip=True)
    dm = GrainDataModule(ds.MSIvsMSSDataset(root, crawler_ext="png", **flips), batch_size=2,
                         seed=4)
    whole = list(dm.train_dataloader(1))
    tail = list(dm.train_dataloader(1, start_batch=3))
    assert len(whole) == 5 and len(tail) == 2
    for a, b in zip(whole[3:], tail):
        np.testing.assert_array_equal(a["source"], b["source"])
    unflipped = GrainDataModule(ds.MSIvsMSSDataset(root, crawler_ext="png", **FLIPS_OFF),
                                batch_size=2, seed=4)
    assert any(not np.array_equal(a["source"], b["source"])
               for a, b in zip(whole, unflipped.train_dataloader(1)))


def test_grain_resume_equals_an_unbroken_run(tmp_path, image_preset):  # noqa: F811
    root = write_chexpert_2(tmp_path / "data")

    def run(out, steps, *extra):
        return train_diffusion.main([
            "--preset", image_preset, "--device", "cpu", "--data-root", str(root),
            "--out", str(out), "--max-steps", str(steps), "--ckpt-every", "2", "--grain",
            "--batch-size", "4", "--use-ema", *extra])[1]

    straight = run(tmp_path / "a", 4)  # 12 items: 3 batches an epoch, a resume mid-epoch
    first = run(tmp_path / "b", 2)
    rest = run(tmp_path / "b", 4, "--resume")
    assert first + rest == straight
    _equal_trees(C.load_payload(tmp_path / "b" / "checkpoints", 4),
                 C.load_payload(tmp_path / "a" / "checkpoints", 4))
    with pytest.raises(SystemExit, match="grain"):
        train_diffusion.main(["--preset", image_preset, "--device", "cpu", "--data-root",
                              str(root), "--out", str(tmp_path / "a"), "--max-steps", "5",
                              "--use-ema", "--batch-size", "4", "--resume"])


def test_grain_batches_reach_the_training_step_in_order(tmp_path, image_preset,  # noqa: F811
                                                        monkeypatch):
    root = write_chexpert_2(tmp_path / "data")
    seen = []
    real = train_diffusion.make_diffusion_train_step

    def spying(*args, **kwargs):
        step = real(*args, **kwargs)

        def wrapped(state, batch, draws):
            seen.append(batch["source"].clone())
            return step(state, batch, draws)

        return wrapped

    monkeypatch.setattr(train_diffusion, "make_diffusion_train_step", spying)
    train_diffusion.main(["--preset", image_preset, "--device", "cpu", "--data-root",
                          str(root), "--max-steps", "3", "--grain", "--batch-size", "5",
                          "--seed", "2"])
    data = presets.build_dataset(presets.PRESETS[image_preset], str(root), seed=2)
    dm = GrainDataModule(data, batch_size=5, seed=2)
    want = list(dm.train_dataloader(0)) + list(dm.train_dataloader(1))[:1]
    assert len(seen) == 3
    for got, batch in zip(seen, want):
        assert torch.equal(got, torch.from_numpy(batch["source"]))


# ---- prefetch --------------------------------------------------------------------


class _Counting:
    def __init__(self, n):
        self.n, self.pulled = n, 0

    def __iter__(self):
        for i in range(self.n):
            self.pulled += 1
            yield {"x": np.full((2, 3), i, np.float32), "y": [np.arange(i, i + 2)],
                   "uid": np.asarray([f"a{i}", f"b{i}"])}


@pytest.mark.parametrize("n,size", [(5, 2), (1, 2), (0, 3), (3, 3), (4, 1)])
def test_prefetch_keeps_order_values_and_pulls_ahead(n, size):
    src = _Counting(n)
    it = prefetch_to_device(src, size=size, device="cpu")
    assert src.pulled == 0  # nothing is read before the first batch is asked for
    out = []
    for i, batch in enumerate(it):
        assert src.pulled == min(n, size + i + 1)
        out.append(batch)
    assert len(out) == n
    for i, batch in enumerate(out):
        assert isinstance(batch["x"], torch.Tensor) and batch["x"].device.type == "cpu"
        torch.testing.assert_close(batch["x"], torch.full((2, 3), float(i)))
        assert torch.equal(batch["y"][0], torch.arange(i, i + 2))
        assert batch["uid"].tolist() == [f"a{i}", f"b{i}"]


class _TwoRankMesh:
    """The parts of a ('data', 'model') DeviceMesh that batch sharding
    reads, as rank 1 of 2 data ranks sees them."""

    mesh_dim_names = ("data", "model")

    def size(self, dim):
        return (2, 1)[dim]

    def get_local_rank(self, axis):
        return {"data": 1, "model": 0}[axis]


def test_prefetch_refuses_a_mesh():
    """With a mesh each batch comes as this rank's rows over 'data' (rank 1
    of 2: the second half); scalars and rows of strings are cut alike."""
    batches = [{"x": np.arange(8, dtype=np.float32).reshape(4, 2) + i, "uid": np.asarray(list("abcd")),
                "step": i} for i in range(3)]
    out = list(prefetch_to_device(iter(batches), device="cpu", mesh=_TwoRankMesh()))
    assert len(out) == 3
    for i, batch in enumerate(out):
        torch.testing.assert_close(batch["x"], torch.arange(4.0, 8.0).reshape(2, 2) + i)
        assert batch["uid"].tolist() == ["c", "d"] and batch["step"] == i
    with pytest.raises(ValueError, match="does not split over 2"):
        next(prefetch_to_device(iter([{"x": np.zeros(3)}]), device="cpu", mesh=_TwoRankMesh()))


# ---- profiling -------------------------------------------------------------------


def test_trace_writes_a_file_holding_the_annotated_region(tmp_path):
    with profiling.trace(tmp_path / "tr"):
        with profiling.annotate("port_region"):
            torch.ones(16, 16) @ torch.ones(16, 16)
    files = list((tmp_path / "tr").glob("*.pt.trace.json"))
    assert len(files) == 1
    events = json.loads(files[0].read_text())["traceEvents"]
    region = [e for e in events if e.get("name") == "port_region"]
    assert region and region[0]["cat"] == "user_annotation"
    start, end = region[0]["ts"], region[0]["ts"] + region[0]["dur"]
    assert any(e.get("name") == "aten::mm" and start <= e["ts"] <= end for e in events)


# ---- the two datasets ------------------------------------------------------------


def _same_items(port, ref):
    assert len(port) == len(ref)
    for i in range(len(ref)):
        a, b = port[i], ref[i]
        assert set(a) == set(b)
        for k in a:
            np.testing.assert_array_equal(a[k], b[k], err_msg=f"item {i} {k}")


COMMON = dict(image_resize=16, image_crop=16, augment_horizontal_flip=True)


def test_msivsmss_items_match_jax(tmp_path):
    root = _colon_tree(tmp_path / "colon", n=6)
    port = ds.MSIvsMSSDataset(root, crawler_ext="png", seed=2, **COMMON)
    ref = jax_ds.MSIvsMSSDataset(root, crawler_ext="png", seed=2, **COMMON)
    assert port.item_pointers == ref.item_pointers
    _same_items(port, ref)
    assert [port[i]["target"] for i in range(6)] == [0, 0, 0, 1, 1, 1]  # MSIMUT, MSS


def test_chexpert_items_and_labels_match_jax(tmp_path):
    base = tmp_path / "CheXpert-v1.0-small"
    rows = ["Path,Sex,Age,Frontal/Lateral,AP/PA,No Finding,Cardiomegaly"]
    cardio = ["-1.0", "0.0", "1.0", "", "1.0", "0.0", ""]
    for i, value in enumerate(cardio):
        rel = f"train/patient{i:05d}/study1/view1_frontal.png"
        rows.append(f"CheXpert-v1.0-small/{rel},{('Male', 'Female', 'Unknown')[i % 3]},"
                    f"{40 + i},Frontal,AP,,{value}")
        rows.append(f"CheXpert-v1.0-small/train/patient{i:05d}/study1/view2_lateral.png,"
                    f"Male,{40 + i},Lateral,,1.0,1.0")  # filtered out
        (base / "train" / rel).parent.mkdir(parents=True)
        png.write_png(base / "train" / rel, _image(20, 18, 1, seed=i)[:, :, 0])
    (base / "train.csv").write_text("\n".join(rows) + "\n")
    port = ds.CheXpertDataset(base / "train", seed=3, **COMMON)
    ref = jax_ds.CheXpertDataset(base / "train", seed=3, **COMMON)
    assert len(port) == len(ref) == 7
    _same_items(port, ref)
    assert [port[i]["target"] for i in range(7)] == [0, 1, 2, 3, 2, 1, 3]
    assert port[0]["uid"] == "train/patient00000/study1/view1_frontal.png"
