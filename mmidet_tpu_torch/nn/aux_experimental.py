"""Auxiliary experimental modules of the reference that no shipped config
wires up (common.py:1372-1528: VAE, RecContrastiveLoss, the modality
feature extractors, DecoderNetwork, negative sampling, the reconstruction
and VAE losses).  The reference instantiates RecContrastiveLoss once
(yolo_test.py:94) and never calls it; the rest is dormant.

Counterpart of ``mmidet_tpu/nn/aux_experimental.py``, in NCHW.  The
submodules carry the flax scope names (``enc1``, ``fc_mu``, ``Conv_0``,
``BatchNorm_0``, ``ConvTranspose_0``, ...), which
``bridge.from_flax_aux`` reads.  Where the JAX package's forms differ from
torch's, the port computes the JAX package's:

  * flax's ``ConvTranspose(3, strides=2, padding="SAME")`` pads the
    dilated input (2, 1), and does not flip its kernel; it is torch's
    ``ConvTranspose2d(3, stride=2, padding=0)`` on the flipped kernel,
    cropped to twice the input.  The reference's
    ``ConvTranspose2d(3, 2, padding=1, output_padding=1)`` pads (1, 2): its
    output is the JAX package's shifted by one pixel, which the JAX
    package's comment calls the same.  At stride 1 both pad (1, 1);
  * the VAE's linear layers read and write the NCHW flatten (the
    reference's); the bridge permutes the JAX package's NHWC-order
    kernels;
  * BatchNorm is flax's (momentum 0.99, eps 1e-5, the biased variance).

Reference quirks kept, as in the JAX package:
  * ``rec_contrastive_loss`` ignores the negative branch: the reference
    comments it out and penalizes ``relu(d(anchor, positive) + margin)``
    (common.py:1437-1442);
  * ``vae_loss`` applies binary_cross_entropy_with_logits to an input the
    decoder already passed through sigmoid (common.py:1520-1526).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from mmidet_tpu_torch.nn.layers import BatchNorm2d


class FlaxConvTranspose(nn.ConvTranspose2d):
    """flax ``ConvTranspose(cout, (3, 3), strides=(s, s), padding="SAME")``
    for s in (1, 2), NCHW; the weight is the flax kernel flipped
    (``bridge.from_flax_aux``)."""

    def __init__(self, cin: int, cout: int, stride: int = 1):
        if stride not in (1, 2):
            raise ValueError(f"stride {stride}: 1 or 2")
        super().__init__(cin, cout, 3, stride, padding=0 if stride == 2
                         else 1)

    def forward(self, x):
        y = super().forward(x)
        s = self.stride[0]
        return y[:, :, :s * x.shape[2], :s * x.shape[3]]


class VAE(nn.Module):
    """Conv VAE: two stride-2 convs -> (mu, logvar) -> two stride-2
    transposed convs with a sigmoid.  Ref: common.py:1372-1419.  The
    linear layers fix the input size: ``img_size`` (h, w), multiples of 4."""

    def __init__(self, input_channels: int = 3, latent_dim: int = 16,
                 img_size: tuple[int, int] = (64, 64)):
        super().__init__()
        h, w = img_size
        self.grid = (h // 4, w // 4)
        flat = self.grid[0] * self.grid[1] * 64
        self.enc1 = nn.Conv2d(input_channels, 32, 3, 2, 1)
        self.enc2 = nn.Conv2d(32, 64, 3, 2, 1)
        self.fc_mu = nn.Linear(flat, latent_dim)
        self.fc_logvar = nn.Linear(flat, latent_dim)
        self.dec_fc = nn.Linear(latent_dim, flat)
        self.dec1 = FlaxConvTranspose(64, 32, 2)
        self.dec2 = FlaxConvTranspose(32, input_channels, 2)

    def forward(self, x, eps: torch.Tensor | None = None,
                generator: torch.Generator | None = None):
        """(sigmoid reconstruction, mu, logvar); ``eps``: the noise
        (default ``torch.randn`` from ``generator``)."""
        b = x.shape[0]
        y = F.relu(self.enc2(F.relu(self.enc1(x))))
        flat = y.reshape(b, -1)
        mu, logvar = self.fc_mu(flat), self.fc_logvar(flat)
        if eps is None:
            eps = torch.randn(mu.shape, generator=generator,
                              device=mu.device, dtype=mu.dtype)
        z = mu + torch.exp(0.5 * logvar) * eps
        d = self.dec_fc(z).reshape(b, 64, *self.grid)
        d = self.dec2(F.relu(self.dec1(d)))
        return torch.sigmoid(d), mu, logvar


def rec_contrastive_loss(anchor, positive, negative=None,
                         margin: float = 1.0):
    """relu(||anchor - positive||_2 + margin).mean() over the last axis:
    the reference's effective formula; the negative branch is dead code
    there (RecContrastiveLoss, common.py:1422-1442)."""
    del negative
    d = torch.sqrt(((anchor - positive) ** 2).sum(-1) + 1e-12)
    return F.relu(d + margin).mean()


class ModalitySpecificFeatureExtractor(nn.Module):
    """conv3x3 -> 64 channels + BN + ReLU.  Ref: common.py:1448-1459."""

    features = 64

    def __init__(self, in_channels: int = 3):
        super().__init__()
        self.Conv_0 = nn.Conv2d(in_channels, self.features, 3, 1, 1)
        self.BatchNorm_0 = BatchNorm2d(self.features, eps=1e-5,
                                       momentum=0.01)

    def forward(self, x):
        return F.relu(self.BatchNorm_0(self.Conv_0(x)))


class ModalityAgnosticFeatureExtractor(ModalitySpecificFeatureExtractor):
    """The same stack at 32 channels.  Ref: common.py:1464-1477."""

    features = 32


class DecoderNetwork(nn.Module):
    """Three stride-1 transposed convs 64 -> 32 -> ``out_channels``, ReLU
    after each.  Ref: common.py:1482-1503."""

    def __init__(self, in_channels: int, out_channels: int):
        super().__init__()
        chans = (in_channels, 64, 32, out_channels)
        for i in range(3):
            setattr(self, f"ConvTranspose_{i}",
                    FlaxConvTranspose(chans[i], chans[i + 1], 1))

    def forward(self, x):
        for i in range(3):
            x = F.relu(getattr(self, f"ConvTranspose_{i}")(x))
        return x


def get_negative_features(batch_features, generator=None, indices=None):
    """The batch shuffled, as negatives.  Ref: common.py:1508-1517."""
    if indices is None:
        indices = torch.randperm(batch_features.shape[0],
                                 generator=generator)
    return batch_features[indices]


def reconstruction_loss(reconstructed, original):
    """MSE.  Ref: common.py:1519-1520."""
    return ((reconstructed - original) ** 2).mean()


def vae_loss(recon_x, x, mu, logvar):
    """sum-BCE-with-logits + KLD, with the reference's quirk of taking the
    sigmoided reconstruction as logits (common.py:1520-1526)."""
    bce = (F.relu(recon_x) - recon_x * x
           + torch.log1p(torch.exp(-recon_x.abs()))).sum()
    kld = -0.5 * (1 + logvar - mu ** 2 - logvar.exp()).sum()
    return bce + kld
