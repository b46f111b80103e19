"""The port's image data against PIL and the JAX package, on the CPU.

* ``data/png.py`` against PIL, bit for bit: files PIL writes (its adaptive
  row filters) in grey, grey + alpha, RGB and RGBA at odd sizes, files the
  port writes with each row filter, and the RGB conversion.
* ``Compose2D`` against the JAX package's with the same flip generator: bit
  for bit without a resize; with a resize (a numpy copy of PIL's bilinear
  filter) within one uint8 level, 2/255 after normalising (measured: 0,
  bit for bit, at every size here).
* ``CheXpert_2_Dataset``, ``MSIvsMSS_2_Dataset`` (PNG files under the
  class directories) and ``AIROGSDataset`` (JPEG, through PIL): items,
  ``get_weights`` and the weighted epoch order bit for bit, with the JAX
  loader at one worker (its threads share one flip generator, so more
  workers would draw in thread order).
* The port's worker processes: the same batches at one and two workers.
"""

import io
import struct
import sys
import zlib

import numpy as np
import pytest
import torch
from PIL import Image

from medfusion_tpu.data import datasets_2d as jax_ds
from medfusion_tpu.data import transforms as jax_tf
from medfusion_tpu.data.datamodule import SimpleDataModule as JaxDM
from medfusion_tpu_torch.data import datasets_2d as ds
from medfusion_tpu_torch.data import png
from medfusion_tpu_torch.data import transforms as tf
from medfusion_tpu_torch.data.datamodule import SimpleDataModule


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


MODES = {"L": 1, "LA": 2, "RGB": 3, "RGBA": 4}
SIZES = ((1, 1), (7, 13), (33, 5), (40, 41))


def _image(h, w, c, seed=0):
    """Gradients plus noise, so that PIL's adaptive filter picks several
    row filters."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[:h, :w]
    base = (3 * yy + 5 * xx)[:, :, None] + rng.integers(0, 24, (h, w, c))
    return (base % 256).astype(np.uint8)


def _pil_png(img, mode):
    buf = io.BytesIO()
    Image.fromarray(img[:, :, 0] if mode == "L" else img, mode).save(buf, format="PNG")
    return buf.getvalue()


@pytest.mark.parametrize("mode", MODES)
def test_png_reader_matches_pil(mode):
    for h, w in SIZES:
        img = _image(h, w, MODES[mode])
        data = _pil_png(img, mode)
        np.testing.assert_array_equal(png.decode_png(data), img)
        pil = Image.open(io.BytesIO(data))
        np.testing.assert_array_equal(png.to_rgb(png.decode_png(data)),
                                      np.asarray(pil.convert("RGB")))


@pytest.mark.parametrize("filters", [0, 1, 2, 3, 4, (0, 1, 2, 3, 4)],
                         ids=["none", "sub", "up", "average", "paeth", "mixed"])
def test_png_writer_row_filters_read_back(filters):
    for mode, c in MODES.items():
        for h, w in SIZES:
            img = _image(h, w, c, seed=h * w)
            data = png.encode_png(img, filters)
            np.testing.assert_array_equal(
                np.asarray(Image.open(io.BytesIO(data))).reshape(h, w, c), img)
            np.testing.assert_array_equal(png.decode_png(data), img)


def _with_ihdr(data, **fields):
    """``data`` with IHDR fields (depth, colour, interlace) replaced."""
    w, h, depth, colour, comp, filt, interlace = struct.unpack(">IIBBBBB", data[16:29])
    vals = {"depth": depth, "colour": colour, "interlace": interlace, **fields}
    body = b"IHDR" + struct.pack(">IIBBBBB", w, h, vals["depth"], vals["colour"], comp,
                                 filt, vals["interlace"])
    return data[:12] + body + struct.pack(">I", zlib.crc32(body)) + data[33:]


def test_png_reader_refuses_what_it_does_not_read(tmp_path):
    data = png.encode_png(_image(4, 4, 1))
    with pytest.raises(ValueError, match="interlaced"):
        png.decode_png(_with_ihdr(data, interlace=1))
    with pytest.raises(ValueError, match="palette"):
        png.decode_png(_with_ihdr(data, colour=3))
    with pytest.raises(ValueError, match="16-bit"):
        png.decode_png(_with_ihdr(data, depth=16))
    buf = io.BytesIO()
    Image.fromarray(_image(4, 4, 3)).convert("P").save(buf, format="PNG")
    with pytest.raises(ValueError, match="palette"):
        png.decode_png(buf.getvalue())
    with pytest.raises(ValueError, match="signature"):
        png.decode_png(b"GIF89a" + data)


def test_read_rgb_names_pil_for_other_formats(tmp_path, monkeypatch):
    path = tmp_path / "x.jpg"
    Image.fromarray(_image(8, 8, 3)).save(path)
    np.testing.assert_array_equal(png.read_rgb(path),
                                  np.asarray(Image.open(path).convert("RGB")))
    monkeypatch.setitem(sys.modules, "PIL", None)
    with pytest.raises(ImportError, match="PIL"):
        png.read_rgb(path)


@pytest.mark.parametrize("hflip,vflip", [(True, False), (True, True), (False, True)])
def test_compose2d_matches_jax_without_resize(hflip, vflip):
    img = _image(37, 29, 3)
    kw = dict(augment_horizontal_flip=hflip, augment_vertical_flip=vflip, image_crop=24)
    port, ref = tf.Compose2D(**kw), jax_tf.Compose2D(**kw)
    rng_p, rng_r = np.random.default_rng(5), np.random.default_rng(5)
    for _ in range(6):
        np.testing.assert_array_equal(port(img, rng_p), ref(Image.fromarray(img), rng_r))


@pytest.mark.parametrize("shape,size", [((300, 340), 256), ((200, 180), 256), ((97, 131), 64),
                                        ((40, 36), 32), ((10, 7), 32), ((33, 33), (20, 47))])
def test_compose2d_matches_jax_with_resize(shape, size):
    img = _image(*shape, 3)
    crop = size if isinstance(size, int) else None
    kw = dict(image_resize=size, image_crop=crop, augment_horizontal_flip=True)
    got = tf.Compose2D(**kw)(img, np.random.default_rng(1))
    want = jax_tf.Compose2D(**kw)(Image.fromarray(img), np.random.default_rng(1))
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=2 / 255)


def test_transform_helpers_match_jax():
    rng = np.random.default_rng(3)
    arr = rng.integers(0, 4, (9, 7, 2)).astype(np.float32)
    np.testing.assert_array_equal(tf.normalize_minmax(arr), jax_tf.normalize_minmax(arr))
    np.testing.assert_array_equal(tf.random_background(arr, np.random.default_rng(2)),
                                  jax_tf.random_background(arr, np.random.default_rng(2)))
    for size in (5, (12, 3), (20, 20)):
        np.testing.assert_array_equal(tf.center_crop(arr, size), jax_tf.center_crop(arr, size))
    u16 = rng.integers(0, 65535, (4, 5)).astype(np.uint16)
    np.testing.assert_array_equal(tf.to_array(u16), jax_tf.to_array(u16))


# ---- datasets ----------------------------------------------------------------


def write_chexpert_2(root, n=12, labels=None, own_column=False, side=(40, 36), seed=0):
    """A CheXpert_2 tree: ``labels/cheXPert_label.csv`` (two folds),
    ``labels/train.csv`` (frontal and lateral rows, Cardiomegaly 0, 1, -1 or
    empty) and grey PNGs ``data/%06d.png`` with every row filter."""
    rng = np.random.default_rng(seed)
    labels = labels if labels is not None else [i % 2 for i in range(n)]
    (root / "labels").mkdir(parents=True)
    (root / "data").mkdir()
    head = "Path,Image Index,fold" + (",Cardiomegaly" if own_column else "")
    rows, truth = [head], ["Path,Sex,Frontal/Lateral,Cardiomegaly"]
    for i in range(n):
        path = f"CheXpert-v1.0/train/patient{i:05d}/study1/view1_frontal.jpg"
        own = f",{(i + 1) % 2}.0" if own_column else ""
        rows.append(f"{path},{i + 1},train{own}")
        lab = labels[i]
        truth.append(f"{path},Male,Frontal,{'' if lab == 'nan' else f'{lab}.0'}")
        truth.append(f"{path},Male,Lateral,1.0")  # filtered out
        img = rng.integers(0, 256, (*side, 1)).astype(np.uint8)
        png.write_png(root / "data" / f"{i + 1:06d}.png", img, filters=(0, 1, 2, 3, 4))
    rows.append("CheXpert-v1.0/valid/patient99999/study1/view1_frontal.jpg,999,valid"
                + (",1.0" if own_column else ""))
    (root / "labels" / "cheXPert_label.csv").write_text("\n".join(rows) + "\n")
    (root / "labels" / "train.csv").write_text("\n".join(truth) + "\n")
    return root


def _same_items(port, ref, n=None):
    assert len(port) == len(ref)
    for i in range(n or len(ref)):
        a, b = port[i], ref[i]
        assert set(a) == set(b)
        for k in a:
            np.testing.assert_array_equal(a[k], b[k], err_msg=f"item {i} {k}")


def _same_batches(dm, ref, epochs=(0, 1)):
    for epoch in epochs:
        got, want = list(dm.train_dataloader(epoch)), list(ref.train_dataloader(epoch))
        assert len(got) == len(want)
        for a, b in zip(got, want):
            assert set(a) == set(b)
            for k in a:
                np.testing.assert_array_equal(a[k], b[k])


COMMON = dict(image_resize=32, image_crop=32, augment_horizontal_flip=True)


@pytest.mark.parametrize("own_column", [False, True], ids=["joined", "own-column"])
def test_chexpert_2_items_weights_and_order_match_jax(tmp_path, own_column):
    root = write_chexpert_2(tmp_path / "chexpert", labels=[0, 1, 1, -1, "nan", 0, 1, 1, 0, 1,
                                                           1, 0],
                            own_column=own_column)
    port = ds.CheXpert_2_Dataset(root, seed=4, **COMMON)
    ref = jax_ds.CheXpert_2_Dataset(root, seed=4, **COMMON)
    assert port.get_weights() == ref.get_weights()
    _same_items(port, ref)
    dm = SimpleDataModule(ds.CheXpert_2_Dataset(root, seed=4, **COMMON), batch_size=4, seed=9,
                          weights=port.get_weights())
    jdm = JaxDM(jax_ds.CheXpert_2_Dataset(root, seed=4, **COMMON), batch_size=4, seed=9,
                num_workers=1, weights=ref.get_weights())
    _same_batches(dm, jdm)


def test_msivsmss_2_items_match_jax(tmp_path):
    root = tmp_path / "colon"
    for k, cls in enumerate(("MSIH", "nonMSIH", "MSIH")):
        (root / cls).mkdir(parents=True, exist_ok=True)
        png.write_png(root / cls / f"tile{k}.png", _image(45, 40, 3, seed=k), filters=4)
        png.write_png(root / cls / f"tile{k + 3}.png", _image(40, 45, 3, seed=k + 3))
    port = ds.MSIvsMSS_2_Dataset(root, crawler_ext="png", seed=2, **COMMON)
    ref = jax_ds.MSIvsMSS_2_Dataset(root, crawler_ext="png", seed=2, **COMMON)
    assert port.item_pointers == ref.item_pointers and port.get_weights() is None
    _same_items(port, ref)


def test_airogs_items_and_weights_match_jax(tmp_path):
    root = tmp_path / "eye" / "images"
    root.mkdir(parents=True)
    rows = ["challenge_id,class"]
    for i, cls in enumerate(("NRG", "RG", "NRG", "NRG", "RG", "NRG")):
        uid = f"TRAIN{i:06d}"
        rows.append(f"{uid},{cls}")
        Image.fromarray(_image(50, 44, 3, seed=i)).save(root / f"{uid}.jpg")
    (root.parent / "train_labels.csv").write_text("\n".join(rows) + "\n")
    port = ds.AIROGSDataset(root, crawler_ext="jpg", seed=1, **COMMON)
    ref = jax_ds.AIROGSDataset(root, crawler_ext="jpg", seed=1, **COMMON)
    assert port.get_weights() == ref.get_weights()
    _same_items(port, ref)
    dm = SimpleDataModule(ds.AIROGSDataset(root, seed=1, **COMMON), batch_size=2, seed=3,
                          weights=port.get_weights())
    jdm = JaxDM(jax_ds.AIROGSDataset(root, seed=1, **COMMON), batch_size=2, seed=3,
                num_workers=1, weights=ref.get_weights())
    _same_batches(dm, jdm)


def test_simple_dataset_items_and_loaders_match_jax(tmp_path):
    root = tmp_path / "plain"
    (root / "a").mkdir(parents=True)
    for i in range(5):
        png.write_png(root / ("a" if i % 2 else "") / f"im{i}.png", _image(34, 30, 2, seed=i),
                      filters=i % 5)
    port = ds.SimpleDataset2D(root, crawler_ext="png", **COMMON)
    ref = jax_ds.SimpleDataset2D(root, crawler_ext="png", **COMMON)
    _same_items(port, ref)
    dm = SimpleDataModule(port, ds_val=port, ds_test=port, batch_size=2)
    jdm = JaxDM(ref, ds_val=ref, ds_test=ref, batch_size=2, num_workers=1)
    for got, want in ((dm.val_dataloader(), jdm.val_dataloader()),
                      (dm.test_dataloader(), jdm.test_dataloader())):
        got, want = list(got), list(want)
        assert [len(b["uid"]) for b in got] == [2, 2, 1]
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a["uid"], b["uid"])
    with pytest.raises(ValueError, match="validation"):
        next(SimpleDataModule(port).val_dataloader())


def test_worker_processes_give_the_same_batches_at_any_count(tmp_path):
    """Batch b of epoch e draws its flips from (seed, e, b): the batches do
    not depend on the number of workers, and a run that starts mid-epoch
    reads the same batches as one that got there."""
    root = write_chexpert_2(tmp_path / "chexpert", n=8)
    runs = {}
    for workers in (1, 2):
        dm = SimpleDataModule(ds.CheXpert_2_Dataset(root, **COMMON), batch_size=2, seed=5,
                              num_workers=workers)
        runs[workers] = list(dm.train_dataloader(1))
    tail = list(SimpleDataModule(ds.CheXpert_2_Dataset(root, **COMMON), batch_size=2, seed=5,
                                 num_workers=1).train_dataloader(1, start_batch=2))
    assert len(runs[1]) == len(runs[2]) == 4 and len(tail) == 2
    for a, b in zip(runs[1], runs[2]):
        for k in a:
            np.testing.assert_array_equal(a[k], b[k])
    for a, b in zip(runs[1][2:], tail):
        np.testing.assert_array_equal(a["source"], b["source"])
