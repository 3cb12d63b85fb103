"""The port's copy of ``paddle_tpu/image.py``.

Image preprocessing utilities (reference: python/paddle/v2/image.py —
load/resize/crop/flip/transform helpers feeding the CHW float pipelines).

PIL + numpy replace the reference's cv2 path; same semantics: images are HWC
uint8 in memory, transformed to CHW float32 for the model.
"""

import io
import tarfile

import numpy as np

__all__ = [
    "load_image_bytes", "load_image", "resize_short", "to_chw",
    "center_crop", "random_crop", "left_right_flip", "simple_transform",
    "load_and_transform", "batch_images_from_tar",
]


def load_image_bytes(data: bytes, is_color: bool = True) -> np.ndarray:
    """Decode encoded image bytes to an HWC (or HW) uint8 array."""
    from PIL import Image
    img = Image.open(io.BytesIO(data))
    img = img.convert("RGB" if is_color else "L")
    return np.asarray(img)


def load_image(path: str, is_color: bool = True) -> np.ndarray:
    with open(path, "rb") as f:
        return load_image_bytes(f.read(), is_color)


def resize_short(im: np.ndarray, size: int) -> np.ndarray:
    """Resize so the shorter edge equals ``size`` (image.py:150)."""
    from PIL import Image
    h, w = im.shape[:2]
    if h > w:
        new_w, new_h = size, int(round(h * size / w))
    else:
        new_w, new_h = int(round(w * size / h)), size
    mode = "RGB" if im.ndim == 3 else "L"
    out = Image.fromarray(im, mode).resize((new_w, new_h))
    return np.asarray(out)


def to_chw(im: np.ndarray, order=(2, 0, 1)) -> np.ndarray:
    """HWC -> CHW (image.py:177)."""
    assert len(im.shape) == len(order)
    return im.transpose(order)


def center_crop(im: np.ndarray, size: int, is_color: bool = True):
    h, w = im.shape[:2]
    h0, w0 = (h - size) // 2, (w - size) // 2
    return im[h0:h0 + size, w0:w0 + size]


def random_crop(im: np.ndarray, size: int, is_color: bool = True,
                rng=None):
    rng = rng or np.random
    h, w = im.shape[:2]
    h0 = int(rng.randint(0, h - size + 1))
    w0 = int(rng.randint(0, w - size + 1))
    return im[h0:h0 + size, w0:w0 + size]


def left_right_flip(im: np.ndarray) -> np.ndarray:
    return im[:, ::-1]


def simple_transform(im: np.ndarray, resize_size: int, crop_size: int,
                     is_train: bool, is_color: bool = True, mean=None,
                     rng=None) -> np.ndarray:
    """The standard train/eval pipeline (image.py:277): resize-short, then
    random-crop+flip (train) or center-crop (eval), CHW float32, optional
    per-channel or per-pixel mean subtraction."""
    rng = rng or np.random
    im = resize_short(im, resize_size)
    if is_train:
        im = random_crop(im, crop_size, is_color, rng=rng)
        if rng.randint(2) == 0:
            im = left_right_flip(im)
    else:
        im = center_crop(im, crop_size, is_color)
    if im.ndim == 3:
        im = to_chw(im)
    im = im.astype(np.float32)
    if mean is not None:
        mean = np.asarray(mean, np.float32)
        if mean.ndim == 1 and im.ndim == 3:
            mean = mean[:, None, None]
        im -= mean
    return im


def load_and_transform(path: str, resize_size: int, crop_size: int,
                       is_train: bool, is_color: bool = True, mean=None):
    return simple_transform(load_image(path, is_color), resize_size,
                            crop_size, is_train, is_color, mean)


def batch_images_from_tar(data_file: str, dataset_name: str,
                          img2label: dict, num_per_batch: int = 1024):
    """Pre-batch raw images from a tar into pickled batch files
    (image.py:35 — the flowers-style preprocessing cache). Returns the
    meta-file path listing the batch files."""
    import os
    import pickle
    out_path = f"{data_file}_batch"
    meta = os.path.join(out_path, "batch_images_meta")
    if os.path.exists(meta):
        return meta
    os.makedirs(out_path, exist_ok=True)
    data, labels, file_id, names = [], [], 0, []
    with tarfile.open(data_file) as tf:
        for m in tf:
            if m.name not in img2label:
                continue
            data.append(tf.extractfile(m).read())
            labels.append(img2label[m.name])
            if len(data) == num_per_batch:
                name = os.path.join(out_path,
                                    f"batch_{dataset_name}_{file_id}")
                with open(name, "wb") as f:
                    pickle.dump({"data": data, "label": labels}, f,
                                protocol=4)
                names.append(name)
                data, labels, file_id = [], [], file_id + 1
    if data:
        name = os.path.join(out_path, f"batch_{dataset_name}_{file_id}")
        with open(name, "wb") as f:
            pickle.dump({"data": data, "label": labels}, f, protocol=4)
        names.append(name)
    with open(meta, "w") as f:
        f.write("\n".join(names))
    return meta
