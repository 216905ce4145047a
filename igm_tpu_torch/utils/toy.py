"""2-D toy gaussian-mixture prior (AAE's ``prior=toy_gmm``): counterpart of
``igm_tpu/utils/toy.py``.

n equal-weight gaussians placed on the unit circle, each elongated radially
(std 0.35 radial, 0.08 tangential).  The constants are numpy, as there;
sampling draws from a ``torch.Generator`` on the caller's device.
"""
from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch


class ToyGMM:
    def __init__(self, n: int = 10):
        self.n = n
        angles = np.array([2 * i * np.pi / n for i in range(n)])
        self.mus = np.stack([np.cos(angles), np.sin(angles)], axis=1)  # (n, 2)
        covs = []
        for theta in angles:
            v1 = np.array([np.cos(theta), np.sin(theta)])
            v2 = np.array([np.cos(theta + np.pi / 2), np.sin(theta + np.pi / 2)])
            q = np.stack([v1, v2], axis=1)
            d = np.diag(np.array([0.35, 0.08]) ** 2)
            covs.append(q @ d @ q.T)
        self.covs = np.stack(covs, axis=0)  # (n, 2, 2)
        self.chols = np.linalg.cholesky(self.covs)  # (n, 2, 2)

    def sample_from(self, comps: torch.Tensor, eps: torch.Tensor) -> torch.Tensor:
        """Samples (N, 2) of the components ``comps`` (N,) from the N(0, I)
        draws ``eps`` (N, 2): ``mu + L eps``."""
        mus = torch.as_tensor(self.mus, dtype=eps.dtype, device=eps.device)[comps]
        chols = torch.as_tensor(self.chols, dtype=eps.dtype, device=eps.device)[comps]
        return mus + torch.einsum("nij,nj->ni", chols, eps)

    def sample(self, n_samples: int, generator: Optional[torch.Generator] = None,
               device=None):
        """Returns (samples (N, 2), component labels (N,))."""
        comps = torch.randint(0, self.n, (n_samples,), generator=generator, device=device)
        eps = torch.randn((n_samples, 2), generator=generator, device=device)
        return self.sample_from(comps, eps), comps

    def log_prob(self, samples: torch.Tensor) -> torch.Tensor:
        dt, dev = samples.dtype, samples.device
        x = samples[:, None, :] - torch.as_tensor(self.mus, dtype=dt, device=dev)[None]
        inv = torch.as_tensor(np.linalg.inv(self.covs), dtype=dt, device=dev)
        logdet = torch.as_tensor(np.log(np.linalg.det(self.covs)), dtype=dt, device=dev)
        maha = torch.einsum("bni,nij,bnj->bn", x, inv, x)
        log_comp = -0.5 * (maha + logdet + 2 * math.log(2 * math.pi)) - math.log(self.n)
        return torch.logsumexp(log_comp, dim=1)
