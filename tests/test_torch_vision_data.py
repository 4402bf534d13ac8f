"""``paddle_tpu_torch.vision`` transforms, datasets and image loading against
the JAX package's, bit for bit (both are host numpy):

- every transform class and functional under ``np.random.seed``: the same
  draws, the same arrays (dtype, shape, bytes);
- the synthetic datasets (MNIST, FashionMNIST, Cifar10 / 100, Flowers,
  VOC2012), MNIST from local gzip files, ``DatasetFolder`` /
  ``ImageFolder`` over a folder tree (PIL's default loader and
  ``np.load``), the image backends;
- the divergences by design: in DataLoader workers torch seeds numpy per
  worker, so two workers draw different crops (the JAX package's forked
  pool repeats one stream); ``Resize`` indexes the nearest pixel whatever
  its ``interpolation``;
- ``import paddle_tpu_torch.vision`` in a fresh interpreter pulls in no
  ``jax`` and nothing of ``paddle_tpu``, and works with PIL blocked.
"""
import gzip
import os
import struct
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

import paddle_tpu as jp
import paddle_tpu_torch as tp
from paddle_tpu_torch import vision as tv
from test_torch_parity_util import cpu_place  # noqa: F401

JT, TT = jp.vision.transforms, tv.transforms
JD, TD = jp.vision.datasets, tv.datasets
ROOT = Path(__file__).resolve().parent.parent


@pytest.fixture(autouse=True, scope="module")
def _cpu(cpu_place):  # noqa: F811
    yield


def _same(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


def _img(seed=0, shape=(3, 20, 24)):
    return np.random.default_rng(seed).uniform(0, 1, shape).astype(
        np.float32)


def _seeded(make, img, seed):
    """``make(module)(img)`` for both packages, each under
    np.random.seed(seed); returns (port, JAX)."""
    out = []
    for mod in (TT, JT):
        np.random.seed(seed)
        out.append(make(mod)(img))
    return out


TRANSFORMS = {
    "compose": lambda m: m.Compose([m.RandomCrop(12, padding=2),
                                    m.RandomHorizontalFlip(0.5),
                                    m.Normalize([0.5] * 3, [0.2] * 3)]),
    "resize": lambda m: m.Resize((13, 31)),
    "resize_int": lambda m: m.Resize(9, interpolation="bicubic"),
    "center_crop": lambda m: m.CenterCrop((10, 7)),
    "random_crop": lambda m: m.RandomCrop((9, 11)),
    "hflip": lambda m: m.RandomHorizontalFlip(0.7),
    "vflip": lambda m: m.RandomVerticalFlip(0.7),
    "transpose": lambda m: m.Transpose((1, 2, 0)),
    "pad_reflect": lambda m: m.Pad((1, 2, 3, 4), padding_mode="reflect"),
    "pad_fill": lambda m: m.Pad(2, fill=0.5),
    "grayscale": lambda m: m.Grayscale(3),
    "brightness": lambda m: m.BrightnessTransform(0.4),
    "contrast": lambda m: m.ContrastTransform((0.5, 1.5)),
    "saturation": lambda m: m.SaturationTransform(0.6),
    "hue": lambda m: m.HueTransform(0.3),
    "color_jitter": lambda m: m.ColorJitter(0.4, 0.4, 0.4, 0.2),
    "rotation": lambda m: m.RandomRotation(30, "bilinear"),
    "rotation_expand": lambda m: m.RandomRotation((-20, 40), expand=True),
    "rotation_center": lambda m: m.RandomRotation(25, center=(3, 4)),
    "affine": lambda m: m.RandomAffine(15, (0.1, 0.2), (0.8, 1.2), 10,
                                       "bilinear"),
    "affine_shear4": lambda m: m.RandomAffine(0, shear=(-5, 5, -10, 10)),
    "perspective": lambda m: m.RandomPerspective(0.9, 0.4, "bilinear"),
    "erasing": lambda m: m.RandomErasing(0.9),
    "erasing_random": lambda m: m.RandomErasing(0.9, value="random"),
    "erasing_tuple": lambda m: m.RandomErasing(0.9, value=(0.1, 0.2, 0.3)),
    "resized_crop": lambda m: m.RandomResizedCrop(16),
    "resized_crop_fallback": lambda m: m.RandomResizedCrop(
        (8, 10), scale=(1.5, 2.0)),
}


@pytest.mark.parametrize("name", sorted(TRANSFORMS))
@pytest.mark.parametrize("seed", [0, 5])
def test_transform_bit_equal_under_seed(name, seed):
    got, want = _seeded(TRANSFORMS[name], _img(seed), seed)
    _same(got, want)


def test_to_tensor_from_hwc_uint8_and_gray():
    rng = np.random.default_rng(1)
    hwc = rng.integers(0, 256, (9, 7, 3)).astype(np.uint8)
    gray = rng.integers(0, 256, (9, 7)).astype(np.uint8)
    for a in (hwc, gray, hwc.astype(np.float32) / 255.0):
        _same(TT.ToTensor()(a), JT.ToTensor()(a))
        _same(TT.to_tensor(a), JT.to_tensor(a))
    _same(TT.ToTensor("HWC")(hwc), JT.ToTensor("HWC")(hwc))


def test_functionals_bit_equal():
    img = _img(2)
    calls = [
        ("normalize", (img, [0.4, 0.5, 0.6], [0.2, 0.3, 0.4])),
        ("resize", (img, 11)), ("hflip", (img,)), ("vflip", (img,)),
        ("crop", (img, 2, 3, 8, 9)), ("center_crop", (img, 7)),
        ("pad", (img, (2, 3), 0.0, "edge")),
        ("pad", (img, 2, 0.0, "symmetric")),
        ("erase", (img, 1, 2, 4, 5, 0.25)),
        ("to_grayscale", (img,)), ("adjust_brightness", (img, 1.3)),
        ("adjust_contrast", (img, 0.6)), ("adjust_saturation", (img, 1.7)),
        ("adjust_hue", (img, -0.2)), ("adjust_hue", (img * 255, 0.4)),
        ("affine", (img, 20, (2, -1), 1.1, (5, 3), "bilinear", 0.0)),
        ("rotate", (img, 33, "nearest", False, (4, 5))),
        ("rotate", (img, 33, "bilinear", True)),
        ("perspective", (img, [(0, 0), (23, 0), (23, 19), (0, 19)],
                         [(2, 1), (21, 3), (22, 18), (1, 17)], "bilinear")),
    ]
    for name, args in calls:
        _same(getattr(TT, name)(*args), getattr(JT, name)(*args))
    with pytest.raises(ValueError):
        TT.adjust_hue(img, 0.7)


def test_resize_indexes_the_nearest_pixel_whatever_the_mode():
    """Carried from the JAX package: ``interpolation`` is accepted and
    not used."""
    img = _img(3)
    outs = [TT.Resize(15, interpolation=m)(img)
            for m in ("nearest", "bilinear", "bicubic")]
    for o in outs[1:]:
        _same(o, outs[0])
    yi = (np.arange(15) * (20 / 15)).astype(np.int64)
    xi = (np.arange(15) * (24 / 15)).astype(np.int64)
    _same(outs[0], img[:, yi][:, :, xi])


# -- datasets -----------------------------------------------------------------

@pytest.mark.parametrize("make", [
    lambda d: d.MNIST(mode="test"), lambda d: d.FashionMNIST(mode="train"),
    lambda d: d.Cifar10(mode="train"), lambda d: d.Cifar100(mode="test"),
    lambda d: d.Flowers(mode="valid", num_samples=40),
    lambda d: d.VOC2012(mode="test", num_samples=12)],
    ids=["mnist", "fashion", "cifar10", "cifar100", "flowers", "voc"])
def test_synthetic_datasets_bit_equal(make):
    t, j = make(TD), make(JD)
    assert len(t) == len(j)
    for i in (0, 1, len(j) - 1):
        for a, b in zip(t[i], j[i]):
            _same(a, b)


def test_synthetic_images_and_transform_in_getitem():
    for args in ((17, 5, (3, 9, 11), 4), (8, 10, (1, 28, 28), 0)):
        for a, b in zip(TD._synthetic_images(*args),
                        JD._synthetic_images(*args)):
            _same(a, b)
    ds_t = TD.Cifar10(mode="test", transform=TT.Normalize(0.5, 0.25))
    ds_j = JD.Cifar10(mode="test", transform=JT.Normalize(0.5, 0.25))
    _same(ds_t[3][0], ds_j[3][0])
    assert ds_t[3][1] == ds_j[3][1]


def _mnist_files(tmp_path, n=6):
    rng = np.random.default_rng(4)
    imgs = rng.integers(0, 256, (n, 28, 28)).astype(np.uint8)
    labels = rng.integers(0, 10, n).astype(np.uint8)
    ip, lp = tmp_path / "img.gz", tmp_path / "lab.gz"
    with gzip.open(ip, "wb") as f:
        f.write(struct.pack(">IIII", 2051, n, 28, 28) + imgs.tobytes())
    with gzip.open(lp, "wb") as f:
        f.write(struct.pack(">II", 2049, n) + labels.tobytes())
    return str(ip), str(lp)


def test_mnist_from_local_files(tmp_path):
    ip, lp = _mnist_files(tmp_path)
    t = TD.MNIST(image_path=ip, label_path=lp, download=True)
    j = JD.MNIST(image_path=ip, label_path=lp)
    assert len(t) == len(j) == 6
    for i in range(6):
        _same(t[i][0], j[i][0])
        assert t[i][1] == j[i][1]


def _folder_tree(root, ext, save):
    rng = np.random.default_rng(5)
    for cls in ("dog", "cat", "ant"):
        os.makedirs(root / cls / "sub")
        for i in range(2):
            save(root / cls / f"{i}{ext}",
                 rng.integers(0, 256, (6, 8, 3)).astype(np.uint8))
        save(root / cls / "sub" / f"deep{ext}",
             rng.integers(0, 256, (6, 8, 3)).astype(np.uint8))
    (root / "cat" / "notes.txt").write_text("not an image")


def test_dataset_folder_and_image_folder_with_pil(tmp_path):
    from PIL import Image
    _folder_tree(tmp_path, ".png",
                 lambda p, a: Image.fromarray(a).save(p))
    t, j = TD.DatasetFolder(str(tmp_path)), JD.DatasetFolder(str(tmp_path))
    assert t.classes == j.classes == ["ant", "cat", "dog"]
    assert t.samples == j.samples and t.targets == j.targets
    assert len(t) == 9
    for i in (0, 4, 8):
        (ta, tl), (ja, jl) = t[i], j[i]
        _same(np.asarray(ta), np.asarray(ja))
        assert tl == jl
    ti, ji = TD.ImageFolder(str(tmp_path)), JD.ImageFolder(str(tmp_path))
    assert ti.samples == ji.samples and len(ti) == 9
    _same(np.asarray(ti[2][0]), np.asarray(ji[2][0]))


def test_dataset_folder_with_np_load_and_filters(tmp_path):
    _folder_tree(tmp_path, ".npy", lambda p, a: np.save(p, a))
    kw = dict(loader=np.load, extensions=(".npy",),
              transform=TT.Compose([TT.ToTensor(), TT.CenterCrop(4)]))
    t = TD.DatasetFolder(str(tmp_path), **kw)
    kw["transform"] = JT.Compose([JT.ToTensor(), JT.CenterCrop(4)])
    j = JD.DatasetFolder(str(tmp_path), **kw)
    assert t.samples == j.samples and len(t) == 9
    for i in range(9):
        _same(t[i][0], j[i][0])
    only_deep = TD.DatasetFolder(str(tmp_path), loader=np.load,
                                 is_valid_file=lambda p: "deep" in p)
    assert [s for s, _ in only_deep.samples] == [
        str(tmp_path / c / "sub" / "deep.npy") for c in ("ant", "cat",
                                                          "dog")]
    with pytest.raises(RuntimeError):
        TD.DatasetFolder(str(tmp_path / "ant" / "sub"))
    with pytest.raises(RuntimeError):
        TD.ImageFolder(str(tmp_path), extensions=(".jpg",))


def test_image_backends(tmp_path):
    from PIL import Image
    path = tmp_path / "x.png"
    Image.fromarray(np.full((4, 5, 3), 7, np.uint8)).save(path)
    assert tv.get_image_backend() == "pil"
    try:
        with pytest.raises(ValueError):
            tv.set_image_backend("tensor")
        tv.set_image_backend("cv2")
        assert tv.get_image_backend() == "cv2"
    finally:
        tv.set_image_backend("pil")
    with pytest.raises(ValueError):
        tv.image_load(str(path), backend="skimage")
    _same(np.asarray(tv.image_load(str(path))),
          np.asarray(jp.vision.image_load(str(path))))


# -- divergences by design ----------------------------------------------------

class _Draws(tp.io.Dataset):
    """Each item: the crop offsets RandomCrop draws for it."""

    def __len__(self):
        return 8

    def __getitem__(self, i):
        img = np.zeros((1, 40, 40), np.float32)
        img[0] = np.arange(40)[None, :] + 100 * np.arange(40)[:, None]
        crop = TT.RandomCrop(4)(img)
        return np.asarray([crop[0, 0, 0]], np.float32)


def test_dataloader_workers_draw_their_own_crops():
    """torch seeds numpy in each worker: with 2 workers the two halves of
    an epoch draw from two streams (the JAX package's forked pool, which
    does not reseed, would repeat one)."""
    loader = tp.io.DataLoader(_Draws(), batch_size=4, num_workers=2)
    first, second = [b.numpy().ravel().tolist() for b in loader]
    assert first != second
    np.random.seed(0)            # in-process, one stream: the same draws
    same = [_Draws()[i][0] for i in range(2)]
    np.random.seed(0)
    assert [_Draws()[i][0] for i in range(2)] == same


def test_vision_import_needs_no_jax_and_no_pil():
    code = (
        "import sys\n"
        "sys.modules['PIL'] = None\n"
        "sys.modules['cv2'] = None\n"
        "import paddle_tpu_torch as p\n"
        "print('vision' in sys.modules.get('paddle_tpu_torch').__dict__)\n"
        "import paddle_tpu_torch.vision as v\n"
        "print(sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'paddle_tpu')))\n"
        "p.set_device('cpu')\n"
        "net = v.models.LeNet()\n"
        "import numpy as np\n"
        "x = p.to_tensor(np.zeros((1, 1, 28, 28), np.float32))\n"
        "print(net(x).shape, p.vision is v)\n"
        "try:\n"
        "    v.ops.decode_jpeg(p.to_tensor(np.zeros(4, np.uint8)))\n"
        "except ImportError:\n"
        "    print('decode_jpeg needs PIL')\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = str(ROOT)
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.splitlines() == ["False", "[]", "[1, 10] True",
                                       "decode_jpeg needs PIL"]
