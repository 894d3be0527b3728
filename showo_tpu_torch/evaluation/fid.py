"""Frechet Inception Distance (the "FID parity at bf16" gate).

Copy of ``showo_tpu/evaluation/fid.py``, so that ``run_quality`` chains
generation -> scoring in one command on the port's pipelines.

The Frechet statistics / distance math is self-contained numpy (the arrays
are tiny [D] / [D, D]) and gives the JAX package's numbers bit for bit; the
*feature extractor* is pluggable:

  * ``TorchInceptionExtractor`` -- the standard Inception-v3 pool3
    features (torchvision + its ImageNet weights already in torch hub's
    local cache; the port never downloads them: without either it raises
    ImportError).
  * any callable ``images_uint8 [N,H,W,3] -> features [N,D]`` -- the
    smoke runs use the fixed random-projection extractor (the same
    ``default_rng`` matrix as the JAX package's) so the full quality chain
    runs end to end offline.

With the real extractor the numbers are pytorch-fid-comparable (same
mu/sigma/sqrtm convention, Heusel et al. 2017).
"""

from __future__ import annotations

from typing import Callable, Sequence, Tuple

import numpy as np


def activation_statistics(feats: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """(mu [D], sigma [D, D]) of a feature batch [N, D] (N >= 2)."""
    feats = np.asarray(feats, np.float64)
    if feats.ndim != 2 or feats.shape[0] < 2:
        raise ValueError(f"need [N>=2, D] features, got {feats.shape}")
    mu = feats.mean(axis=0)
    sigma = np.cov(feats, rowvar=False)
    return mu, np.atleast_2d(sigma)


def _sqrtm_psd(mat: np.ndarray) -> np.ndarray:
    """Matrix square root of a (near-)PSD symmetric matrix via eigh.

    pytorch-fid uses scipy.linalg.sqrtm on sigma1 @ sigma2; we instead
    compute sqrtm(s1^1/2 s2 s1^1/2) which is symmetric PSD by
    construction — same trace (the only thing FID uses), numerically
    stabler, no complex drift."""
    mat = (mat + mat.T) / 2.0
    w, v = np.linalg.eigh(mat)
    w = np.clip(w, 0.0, None)
    return (v * np.sqrt(w)) @ v.T


def frechet_distance(mu1, sigma1, mu2, sigma2, eps: float = 1e-6) -> float:
    """||mu1-mu2||^2 + Tr(s1 + s2 - 2 (s1 s2)^1/2)."""
    mu1, mu2 = np.asarray(mu1, np.float64), np.asarray(mu2, np.float64)
    sigma1 = np.asarray(sigma1, np.float64) + eps * np.eye(mu1.size)
    sigma2 = np.asarray(sigma2, np.float64) + eps * np.eye(mu2.size)
    s1h = _sqrtm_psd(sigma1)
    covmean_tr = np.trace(_sqrtm_psd(s1h @ sigma2 @ s1h))
    diff = mu1 - mu2
    return float(diff @ diff + np.trace(sigma1) + np.trace(sigma2)
                 - 2.0 * covmean_tr)


def extract_features(images: np.ndarray, extractor: Callable,
                     batch_size: int = 32) -> np.ndarray:
    """images: uint8 NHWC (or float in [-1,1], converted) -> [N, D]."""
    images = np.asarray(images)
    if images.dtype != np.uint8:
        images = ((np.clip(images, -1, 1) + 1) * 127.5).round().astype(np.uint8)
    outs = []
    for i in range(0, len(images), batch_size):
        outs.append(np.asarray(extractor(images[i:i + batch_size])))
    return np.concatenate(outs, axis=0)


def compute_fid(images_a: np.ndarray, images_b: np.ndarray,
                extractor: Callable, batch_size: int = 32) -> float:
    """FID between two image sets under ``extractor``."""
    fa = extract_features(images_a, extractor, batch_size)
    fb = extract_features(images_b, extractor, batch_size)
    return frechet_distance(*activation_statistics(fa),
                            *activation_statistics(fb))


def fid_from_dirs(dir_a: str, dir_b: str, extractor: Callable,
                  resolution: int = 299, batch_size: int = 32) -> float:
    """FID between two directories of images (pytorch-fid CLI analogue)."""
    from PIL import Image
    import os

    def load(d):
        paths = sorted(
            os.path.join(d, f) for f in os.listdir(d)
            if f.lower().endswith((".png", ".jpg", ".jpeg", ".webp")))
        if len(paths) < 2:
            raise ValueError(f"{d}: need >=2 images, found {len(paths)}")
        return np.stack([
            np.asarray(Image.open(p).convert("RGB")
                       .resize((resolution, resolution), Image.BICUBIC))
            for p in paths])

    return compute_fid(load(dir_a), load(dir_b), extractor, batch_size)


class RandomProjectionExtractor:
    """Deterministic random-projection features — the offline smoke
    extractor (tiny-dims chain tests; NOT comparable to Inception FID).

    Projects 8x8-average-pooled pixels through a fixed Gaussian matrix;
    distributional differences in color/structure still move the metric,
    so the chain tests can assert FID(x, x) == 0 < FID(x, y)."""

    def __init__(self, dim: int = 64, seed: int = 0, pool: int = 8):
        self.dim, self.seed, self.pool = dim, seed, pool
        self._w = None

    def __call__(self, images: np.ndarray) -> np.ndarray:
        x = np.asarray(images, np.float32) / 255.0
        n, h, w, c = x.shape
        p = self.pool
        x = x[:, :h - h % p, :w - w % p]
        x = x.reshape(n, h // p, p, w // p, p, c).mean(axis=(2, 4))
        x = x.reshape(n, -1)
        if self._w is None or self._w.shape[0] != x.shape[1]:
            rng = np.random.default_rng(self.seed)
            self._w = rng.standard_normal((x.shape[1], self.dim)).astype(
                np.float32) / np.sqrt(x.shape[1])
        return x @ self._w


class TorchInceptionExtractor:
    """Inception-v3 pool3 features (pytorch-fid convention) on ``device``.

    Gated on torchvision and its ``IMAGENET1K_V1`` weights in torch hub's
    local cache (``torch.hub.get_dir()/checkpoints``): the port reads local
    files only, so without either it raises ImportError with a pointer."""

    def __init__(self, device: str = "cpu"):
        import os

        import torch
        try:
            from torchvision.models import Inception_V3_Weights, inception_v3
        except ImportError as e:  # pragma: no cover - env-dependent
            raise ImportError(
                "TorchInceptionExtractor needs torchvision (+ weights); "
                "pass a custom extractor or run on a host that has them"
            ) from e
        weights = Inception_V3_Weights.IMAGENET1K_V1
        cached = os.path.join(torch.hub.get_dir(), "checkpoints",
                              os.path.basename(weights.url))
        if not os.path.exists(cached):
            raise ImportError(
                f"TorchInceptionExtractor: {cached} not found; the port "
                f"never downloads weights (place them there)")
        self._torch = torch
        m = inception_v3(weights=weights, aux_logits=True)
        m.fc = torch.nn.Identity()
        self._model = m.eval().to(device)
        self._device = device

    def __call__(self, images: np.ndarray) -> np.ndarray:
        torch = self._torch
        x = torch.from_numpy(np.asarray(images, np.float32) / 255.0)
        x = x.permute(0, 3, 1, 2).to(self._device)
        x = torch.nn.functional.interpolate(
            x, size=(299, 299), mode="bilinear", align_corners=False)
        x = (x - 0.5) / 0.5  # inception's [-1,1] convention
        with torch.no_grad():
            return self._model(x).cpu().numpy()
