"""The port's small host-side modules against ``paddle_tpu``'s on the CPU:
``image`` (every transform bitwise the reference's on the same inputs and
the same ``RandomState``; ``batch_images_from_tar`` writes the same
pickles), ``plot`` (headless under ``DISABLE_PLOT`` and through
matplotlib's Agg backend) and ``version`` (its fields agree with
``__version__``)."""

import io
import os
import tarfile

import numpy as np
import pytest

import paddle_tpu.image as jimage
import paddle_tpu.plot as jplot
import paddle_tpu_torch as T
import paddle_tpu_torch.image as timage
import paddle_tpu_torch.plot as tplot
from paddle_tpu_torch import version as tversion


def png(arr):
    from PIL import Image
    buf = io.BytesIO()
    Image.fromarray(arr).save(buf, format="PNG")
    return buf.getvalue()


def bitwise(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert (a.dtype, a.shape) == (b.dtype, b.shape)
    assert a.tobytes() == b.tobytes()


@pytest.fixture
def rgb():
    return np.random.RandomState(0).randint(0, 256, (37, 52, 3), np.uint8)


@pytest.mark.parametrize("is_color", [True, False])
def test_load_image_bytes_and_file(tmp_path, rgb, is_color):
    data = png(rgb)
    bitwise(timage.load_image_bytes(data, is_color),
            jimage.load_image_bytes(data, is_color))
    p = tmp_path / "x.png"
    p.write_bytes(data)
    got = timage.load_image(str(p), is_color)
    bitwise(got, jimage.load_image(str(p), is_color))
    assert got.ndim == (3 if is_color else 2)


@pytest.mark.parametrize("shape", [(37, 52, 3), (52, 37, 3), (40, 29)])
@pytest.mark.parametrize("size", [16, 33])
def test_resize_short(shape, size):
    im = np.random.RandomState(1).randint(0, 256, shape, np.uint8)
    got = timage.resize_short(im, size)
    bitwise(got, jimage.resize_short(im, size))
    assert min(got.shape[:2]) == size


def test_chw_crops_and_flip(rgb):
    bitwise(timage.to_chw(rgb), jimage.to_chw(rgb))
    bitwise(timage.to_chw(rgb, (1, 0, 2)), jimage.to_chw(rgb, (1, 0, 2)))
    bitwise(timage.center_crop(rgb, 24), jimage.center_crop(rgb, 24))
    bitwise(timage.left_right_flip(rgb), jimage.left_right_flip(rgb))
    tr, jr = np.random.RandomState(3), np.random.RandomState(3)
    for _ in range(5):
        bitwise(timage.random_crop(rgb, 20, rng=tr),
                jimage.random_crop(rgb, 20, rng=jr))


@pytest.mark.parametrize("is_train", [True, False])
@pytest.mark.parametrize("mean", [None, [104.0, 117.0, 124.0], "pixel"])
def test_simple_transform(rgb, is_train, mean):
    if mean == "pixel":
        mean = np.random.RandomState(2).rand(3, 24, 24).astype(np.float32)
    tr, jr = np.random.RandomState(4), np.random.RandomState(4)
    for _ in range(4):         # the flip draw differs across calls
        bitwise(timage.simple_transform(rgb, 32, 24, is_train, mean=mean,
                                        rng=tr),
                jimage.simple_transform(rgb, 32, 24, is_train, mean=mean,
                                        rng=jr))
    assert tr.randint(1 << 30) == jr.randint(1 << 30)   # same draws taken


def test_simple_transform_gray_and_global_rng(tmp_path, rgb):
    gray = rgb[..., 0]
    np.random.seed(11)
    got = timage.simple_transform(gray, 30, 20, True, is_color=False)
    np.random.seed(11)
    bitwise(got, jimage.simple_transform(gray, 30, 20, True,
                                         is_color=False))
    p = tmp_path / "x.png"
    p.write_bytes(png(rgb))
    np.random.seed(12)
    got = timage.load_and_transform(str(p), 32, 24, True)
    np.random.seed(12)
    bitwise(got, jimage.load_and_transform(str(p), 32, 24, True))
    assert got.shape == (3, 24, 24) and got.dtype == np.float32


def _image_tar(path):
    rng = np.random.RandomState(5)
    names = {}
    with tarfile.open(path, "w") as tf:
        for i in range(7):
            data = png(rng.randint(0, 256, (8, 8, 3), np.uint8))
            info = tarfile.TarInfo(f"jpg/image_{i:05d}.jpg")
            info.size = len(data)
            tf.addfile(info, io.BytesIO(data))
            if i != 3:                        # one image has no label
                names[info.name] = i % 3
    return names


def test_batch_images_from_tar_same_pickles(tmp_path):
    out = {}
    for side, mod in (("t", timage), ("j", jimage)):
        d = tmp_path / side
        d.mkdir()
        tar = str(d / "images.tar")
        labels = _image_tar(tar)
        meta = mod.batch_images_from_tar(tar, "train", labels,
                                         num_per_batch=4)
        names = open(meta).read().split("\n")
        out[side] = (os.path.relpath(meta, d),
                     [os.path.relpath(n, d) for n in names],
                     [open(n, "rb").read() for n in names])
        # a second call finds the meta file and writes nothing
        assert mod.batch_images_from_tar(tar, "train", labels) == meta
    assert out["t"] == out["j"]
    assert len(out["t"][1]) == 2


def test_ploter_headless(monkeypatch, capsys):
    monkeypatch.setenv("DISABLE_PLOT", "True")
    printed = []
    for mod in (tplot, jplot):
        p = mod.Ploter("train cost", "test cost")
        for step in range(3):
            p.append("train cost", step, 1.0 / (step + 1))
        p.append("test cost", 2, 0.25)
        p.plot()
        printed.append(capsys.readouterr().out)
        p.reset()
        p.plot()
        assert capsys.readouterr().out == ""
    assert printed[0] == printed[1]
    assert "train cost: step 2 value 0.3333333333333333" in printed[0]


def test_ploter_matplotlib(monkeypatch, tmp_path):
    pytest.importorskip("matplotlib")
    monkeypatch.delenv("DISABLE_PLOT", raising=False)
    p = tplot.Ploter("cost")
    assert p._plt is not None
    for step in range(4):
        p.append("cost", step, float(4 - step))
    path = tmp_path / "cost.png"
    p.plot(str(path))
    assert path.read_bytes()[:8] == b"\x89PNG\r\n\x1a\n"
    d = tplot.PlotData()
    d.append(1, 2.0)
    assert (d.step, d.value) == ([1], [2.0])
    d.reset()
    assert (d.step, d.value) == ([], [])


def test_version_fields(capsys):
    assert T.__version__ is tversion.__version__ == "0.1.0"
    assert (tversion.major, tversion.minor, tversion.patch) == tuple(
        int(p) for p in tversion.__version__.split("."))
    assert tversion.rc == 0 and tversion.istaged is False
    assert tversion.with_tpu is False
    tversion.show()
    assert capsys.readouterr().out == "paddle_tpu_torch 0.1.0\n"
    import paddle_tpu.version as jversion
    assert {k for k in vars(jversion) if not k.startswith("__")} == {
        k for k in vars(tversion) if not k.startswith("__")}
