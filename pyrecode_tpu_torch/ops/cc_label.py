"""Connected-component labelling (8-connectivity) in plain PyTorch.

Port of pyrecode_tpu/ops/cc_label.py:label_components, the labelling half
of the L2/L4 kernel's twin (:mod:`.hopper_label`).  Each foreground pixel
starts with its own linear index; rounds of a 3x3 minimum over shifted views
(int64, exact; no float pooling) run to a fixed point, where every pixel
holds its component's smallest index: scipy.ndimage.label's first pixel in
raster order.  Each round also lowers the label of a pixel's label to that
minimum (hooking, one ``scatter_reduce``) and then lets every pixel take the
label its label's pixel holds, twice (pointer jumping).  A label is always a
member of the pixel's component and never above the pixel's index, so the
fixed point is the same; the rounds drop from the component's geodesic
length (380 for a 128x256 spiral) to a handful (8).  Components are then
numbered 1..n in raster order of those first pixels.
"""

from __future__ import annotations

import torch


def _box3_min(lbl: torch.Tensor, background: int) -> torch.Tensor:
    """Minimum over each pixel's 3x3 neighbourhood of (B, H, W), edges
    padded with ``background``."""
    padded = torch.nn.functional.pad(lbl, (1, 1, 1, 1), value=background)
    _, H, W = lbl.shape
    rows = torch.minimum(torch.minimum(padded[:, :, :W], padded[:, :, 1:W + 1]),
                         padded[:, :, 2:W + 2])
    return torch.minimum(torch.minimum(rows[:, :H], rows[:, 1:H + 1]), rows[:, 2:H + 2])


def root_labels(mask: torch.Tensor) -> torch.Tensor:
    """(B, H, W) bool -> (B, H*W) int64: each foreground pixel's component
    minimum linear index, H*W on the background."""
    B, H, W = mask.shape
    n = H * W
    mask = mask.to(torch.bool)
    lin = torch.arange(n, dtype=torch.int64, device=mask.device).reshape(1, H, W)
    lbl = torch.where(mask, lin, n).reshape(B, n)
    flat_mask = mask.reshape(B, n)
    own = lin.reshape(1, n).expand(B, n)

    def jump(x):       # column n is the background's label, n
        return torch.gather(torch.nn.functional.pad(x, (0, 1), value=n), 1, x)

    while True:
        nb = torch.where(mask, _box3_min(lbl.reshape(B, H, W), n), n).reshape(B, n)
        # a background pixel hooks itself, a no-op: sending the ~99% background
        # of a frame to one shared column serialises the scatter on a GPU
        hooked = lbl.scatter_reduce(1, torch.where(flat_mask, lbl, own), nb, reduce="amin")
        nxt = jump(jump(torch.minimum(hooked, nb)))
        if torch.equal(nxt, lbl):
            return lbl
        lbl = nxt


def label_components(mask: torch.Tensor):
    """Label the 8-connected components of a boolean batch (B, H, W).

    Returns ``labels`` (B, H, W) int64, 0 on the background and 1..n per
    frame in raster order of each component's first pixel, and ``counts``
    (B,) int32, the components per frame.
    """
    B, H, W = mask.shape
    n = H * W
    roots = root_labels(mask)
    flat_mask = mask.reshape(B, n).to(torch.bool)
    lin = torch.arange(n, dtype=torch.int64, device=mask.device)
    is_root = flat_mask & (roots == lin)
    rank = torch.cumsum(is_root, dim=1)            # root k -> k (1-based)
    labels = torch.gather(rank, 1, roots.clamp(max=n - 1))
    labels = torch.where(flat_mask, labels, 0).reshape(B, H, W)
    return labels, is_root.sum(dim=1, dtype=torch.int32)
