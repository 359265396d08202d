"""Bake-time blue-noise mask generator (void-and-cluster).

The reference ships pre-generated blue-noise textures under
assets/engine/blue-noise/ and binds them for stochastic sampling (film
grain, shadow PCF discs — GpuScene.cpp:364-474). This tool generates our
equivalent: a toroidal 128x128 rank mask via Ulichney's void-and-cluster
algorithm, committed as arkoserenderer/assets/data/bluenoise_128.npy
(uint16 ranks; (rank + 0.5) / N**2 gives the [0,1) mask). Salted toroidal
shifts + per-frame golden-ratio Cranley-Patterson rotation decorrelate
uses without destroying the spectrum (ops/noise.py).

Run: python tools/gen_bluenoise.py  (regenerates the committed asset;
deterministic for a given seed).
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

OUT = Path(__file__).resolve().parents[1] / (
    "arkoserenderer/assets/data/bluenoise_128.npy"
)


def _energy_kernel(n: int, sigma: float) -> np.ndarray:
    ax = np.arange(n)
    d = np.minimum(ax, n - ax).astype(np.float64)
    d2 = d[:, None] ** 2 + d[None, :] ** 2
    return np.exp(-d2 / (2.0 * sigma * sigma))


def void_and_cluster(n: int = 128, sigma: float = 1.9, seed: int = 20260818,
                     initial_frac: float = 0.1) -> np.ndarray:
    """Returns (n, n) int32 ranks in [0, n*n): thresholding the mask at any
    level yields a blue-noise (high-frequency, isotropic) point set."""
    rng = np.random.default_rng(seed)
    total = n * n
    kernel = _energy_kernel(n, sigma)
    kf = np.fft.rfft2(kernel)

    def conv(b):
        return np.fft.irfft2(np.fft.rfft2(b.astype(np.float64)) * kf, s=(n, n))

    def add_at(energy, y, x, sign):
        energy += sign * np.roll(np.roll(kernel, y, axis=0), x, axis=1)

    m = int(total * initial_frac)
    binary = np.zeros((n, n), bool)
    binary.flat[rng.choice(total, m, replace=False)] = True
    energy = conv(binary)

    # Phase 0: relax the prototype pattern (swap tightest cluster into the
    # largest void until it stops moving).
    for _ in range(total):
        e_ones = np.where(binary, energy, -np.inf)
        cy, cx = np.unravel_index(np.argmax(e_ones), (n, n))
        binary[cy, cx] = False
        add_at(energy, cy, cx, -1.0)
        e_zeros = np.where(binary, np.inf, energy)
        vy, vx = np.unravel_index(np.argmin(e_zeros), (n, n))
        binary[vy, vx] = True
        add_at(energy, vy, vx, +1.0)
        if (vy, vx) == (cy, cx):
            break

    ranks = np.full((n, n), -1, np.int32)

    # Phase 1: peel the prototype's points off tightest-cluster-first,
    # assigning ranks m-1 .. 0.
    b = binary.copy()
    e = energy.copy()
    for r in range(m - 1, -1, -1):
        e_ones = np.where(b, e, -np.inf)
        cy, cx = np.unravel_index(np.argmax(e_ones), (n, n))
        b[cy, cx] = False
        add_at(e, cy, cx, -1.0)
        ranks[cy, cx] = r

    # Phase 2: grow from the prototype by filling the largest void,
    # assigning ranks m .. total-1.
    b = binary.copy()
    e = energy.copy()
    for r in range(m, total):
        e_zeros = np.where(b, np.inf, e)
        vy, vx = np.unravel_index(np.argmin(e_zeros), (n, n))
        b[vy, vx] = True
        add_at(e, vy, vx, +1.0)
        ranks[vy, vx] = r

    assert ranks.min() == 0 and ranks.max() == total - 1
    assert len(np.unique(ranks)) == total
    return ranks


def main() -> None:
    ranks = void_and_cluster()
    OUT.parent.mkdir(parents=True, exist_ok=True)
    np.save(OUT, ranks.astype(np.uint16))
    mask = (ranks + 0.5) / ranks.size
    # Report spectral quality: low-frequency radial energy should be far
    # below white noise's.
    f = np.fft.fftshift(np.abs(np.fft.fft2(mask - mask.mean())))
    n = mask.shape[0]
    yy, xx = np.mgrid[:n, :n]
    rad = np.hypot(yy - n // 2, xx - n // 2)
    low = f[rad < n / 8].mean()
    high = f[rad > n / 3].mean()
    print(f"wrote {OUT} ({ranks.shape}, low/high spectral ratio "
          f"{low / high:.4f} — blue noise wants << 1)")


if __name__ == "__main__":
    main()
