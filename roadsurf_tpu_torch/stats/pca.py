"""The PCA procedure with Kaiser / broken-stick component selection (a copy
of the reference package's ``stats/pca.py``, the upstream
fct_statistics.py), with the decomposition in PyTorch.

``calculate_pca`` computes what the reference computes with scikit-learn
(1.9: ``StandardScaler().fit_transform`` then ``PCA(n_components=min(F,
N)).fit_transform``) in float64 on a chosen device, the card by default:
the same solver choice (the covariance's eigendecomposition for tall data,
N >= 10·F with F <= 1000; otherwise a full SVD of the centred data), the
same explained variances and signs (each component's largest |loading|
positive) and the same coordinates. The figures are matplotlib (the
individuals as .jpg, the variables' biplot as .webp through Pillow).
"""

from __future__ import annotations

import io
import os
from dataclasses import dataclass

import numpy as np
import pandas as pd
import torch

from ..utils.device import resolve_device
from ..utils.misc import ensure_dir_exists


def evplot(ev):
    """Kaiser rule and broken-stick model (MacArthur 1957) bar plots;
    returns (broken-stick values, figure)."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    n = len(ev)
    j = np.arange(n) + 1
    bsm = [1 / n]
    for k in range(n - 1):
        bsm.append(bsm[k] + 1 / (n - 1 - k))
    bsm = [100 * x / n for x in bsm]
    bsm.reverse()
    avg_ev = sum(ev) / len(ev)

    fig = plt.figure(figsize=(8, 8))
    ax = fig.add_subplot(2, 1, 1)
    bx = fig.add_subplot(2, 1, 2)
    ax.bar(j, ev)
    ax.axhline(y=avg_ev, color="r", linestyle="-")
    bx.bar(j - 0.25, ev, color="y", width=0.5)
    bx.bar(j + 0.25, bsm, color="r", width=0.5)
    return bsm, fig


def determine_pc_num(ev, bsm) -> int:
    """The number of components to keep: the smaller of Kaiser's and the
    broken stick's, clamped to [2, 10]."""
    ev = np.asarray(ev)
    kaiser = int(np.sum(ev > ev.mean()))
    bsm_keep = int(np.sum([e > b for e, b in zip(ev, bsm)]))
    keep = min(kaiser, bsm_keep)
    if keep < 2:
        return 2
    if keep > 10:
        return 10
    return keep


@dataclass
class PCAResult:
    """The fitted decomposition as numpy arrays, under scikit-learn's
    names (what ``plot_pca`` and ``pca_procedure`` read)."""
    components_: np.ndarray                # (n_components, F)
    explained_variance_: np.ndarray        # (n_components,)
    explained_variance_ratio_: np.ndarray  # (n_components,)
    n_components_: int
    solver: str                            # "covariance_eigh" or "full"


def _standardize(x: torch.Tensor) -> torch.Tensor:
    """scikit-learn's StandardScaler: centre, divide by the population std
    (the corrected two-pass variance); a feature whose variance is within
    the two-pass algorithm's error bound of 0 keeps scale 1."""
    n = x.shape[0]
    mean = x.sum(0) / n
    temp = x - mean
    correction = temp.sum(0)
    var = ((temp * temp).sum(0) - correction * correction / n) / n
    eps = torch.finfo(torch.float64).eps
    constant = var <= n * eps * var + (n * mean * eps) ** 2
    scale = torch.where(constant, torch.ones_like(var), var.sqrt())
    return temp / scale


# loadings whose magnitudes agree to this relative tolerance are a tie
TIE = 1e-9


def _flip_signs(vt: torch.Tensor) -> torch.Tensor:
    """The signs that make each row's largest |value| positive, as
    scikit-learn's ``svd_flip(u_based_decision=False)``; where several
    agree to ``TIE`` (a tie the rounding of one eigensolver or another
    decides), the first of them, so the card and the CPU agree."""
    m = vt.abs()
    top = m.max(1, keepdim=True).values
    idx = (m >= top * (1 - TIE)).int().argmax(1)
    return torch.sign(vt.gather(1, idx[:, None]))


def calculate_pca(dataset: pd.DataFrame, features, to_describe, label_pc,
                  device="cuda"):
    """StandardScaler then PCA over the ``features`` columns of ``dataset``,
    in float64 on ``device``; returns (the fit as a ``PCAResult``, the
    coordinates of each row as an (N, n_components) numpy array)."""
    dev = resolve_device(device)
    dataset = dataset.reset_index(drop=True)
    x = _standardize(torch.as_tensor(
        np.ascontiguousarray(dataset.loc[:, features].values,
                             dtype=np.float64), device=dev))
    n, f = x.shape
    n_components = min(f, n)
    mean = x.sum(0) / n
    if f <= 1000 and n >= 10 * f:
        # tall and skinny: the covariance, centred after the product
        solver = "covariance_eigh"
        c = x.T @ x
        c -= n * mean[:, None] * mean[None, :]
        c /= n - 1
        ev, vecs = torch.linalg.eigh(c)
        ev, vecs = ev.flip(0), vecs.flip(1)
        ev = ev.clamp(min=0.0)
        vt = vecs.T
        vt = vt * _flip_signs(vt)
        coor = (x - mean) @ vt[:n_components].T
    else:
        solver = "full"
        u, s, vt = torch.linalg.svd(x - mean, full_matrices=False)
        ev = s * s / (n - 1)
        signs = _flip_signs(vt)
        vt = vt * signs
        coor = u[:, :n_components] * signs[:n_components, 0] \
            * s[:n_components]
    ratio = ev / ev.sum()

    def out(t):
        return t.detach().cpu().numpy()

    pca = PCAResult(
        components_=out(vt[:n_components]).copy(),
        explained_variance_=out(ev[:n_components]).copy(),
        explained_variance_ratio_=out(ratio[:n_components]).copy(),
        n_components_=n_components, solver=solver)
    return pca, out(coor)


def _save_webp(fig, path: str):
    """A matplotlib figure as .webp through Pillow."""
    from PIL import Image
    buf = io.BytesIO()
    fig.savefig(buf, format="png", bbox_inches="tight")
    buf.seek(0)
    Image.open(buf).convert("RGB").save(path, "WEBP")


def _safe_equal_aspect(ax):
    """aspect=1 only when both axes have real extent (a degenerate range
    makes matplotlib's transform singular on save)."""
    x0, x1 = ax.get_xlim()
    y0, y1 = ax.get_ylim()
    if abs(x1 - x0) > 1e-12 and abs(y1 - y0) > 1e-12:
        ax.set_aspect(1)


def plot_pca(coor_PC, results_PCA, pca, features, targets, to_describe,
             pc_to_plot=2, dirpath_images="images", file_prefix="PCA_",
             title_graph="PCA"):
    """The individuals' scatter (.jpg) and the variables' biplot (.webp)
    for each pair of PC1 and another component."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.colors as mcolors
    import matplotlib.pyplot as plt

    written = []
    expl = [round(x * 100, 2)
            for x in pca.explained_variance_ratio_.tolist()]
    loadings = pca.components_.T * np.sqrt(pca.explained_variance_)
    colors = [k[4:] for k in mcolors.TABLEAU_COLORS.keys()][:len(targets)]

    for pc in range(2, pc_to_plot + 1):
        fig = plt.figure(figsize=(8, 8))
        ax = fig.add_subplot(1, 1, 1)
        ax.set_xlabel(f"Principal Component 1 ({expl[0]}%)", fontsize=15)
        ax.set_ylabel(f"Principal Component {pc} ({expl[pc - 1]}%)",
                      fontsize=15)
        ax.set_title(title_graph, fontsize=20)
        for target, color in zip(targets, colors):
            keep = results_PCA[to_describe] == target
            ax.scatter(results_PCA.loc[keep, "PC1"],
                       results_PCA.loc[keep, f"PC{pc}"], c=color, s=50)
        ax.legend([str(t) for t in targets])
        _safe_equal_aspect(ax)
        ax.grid()
        p = os.path.join(dirpath_images,
                         file_prefix + f"PC1{pc}_individuals.jpg")
        fig.savefig(p, bbox_inches="tight")
        plt.close(fig)
        written.append(p)

        # the variables' biplot: loading vectors with their labels
        fig = plt.figure(figsize=(8, 8))
        ax = fig.add_subplot(1, 1, 1)
        ax.set_xlabel(f"Principal component 1 ({expl[0]}%)")
        ax.set_ylabel(f"Principal component {pc} ({expl[pc - 1]}%)")
        ax.set_title(title_graph)
        for i, feature in enumerate(features):
            ax.plot([0, loadings[i, 0]], [0, loadings[i, pc - 1]], "k-",
                    lw=1)
            ax.annotate(str(feature),
                        (loadings[i, 0], loadings[i, pc - 1]),
                        ha="center", va="bottom")
        _safe_equal_aspect(ax)
        ax.grid()
        p = os.path.join(dirpath_images,
                         file_prefix + f"PC1{pc}_features.webp")
        _save_webp(fig, p)
        plt.close(fig)
        written.append(p)
    return written


def pca_tables(dataset: pd.DataFrame, features, to_describe,
               dirpath_tables="tables", file_prefix="PCA_",
               device="cuda"):
    """The procedure's tables: the coordinates with ``to_describe``
    (``values.csv``), the loading and correlation matrices; returns (the
    paths written, the fit, the coordinates, their frame)."""
    written = []
    ensure_dir_exists(dirpath_tables)
    pca, coor = calculate_pca(dataset, features, to_describe, None,
                              device=device)
    label_pc = [f"PC{x}" for x in range(1, coor.shape[1] + 1)]
    coor_df = pd.DataFrame(coor, columns=label_pc)
    results = pd.concat(
        [coor_df, dataset.reset_index(drop=True)[to_describe]], axis=1)
    p = os.path.join(dirpath_tables, file_prefix + "values.csv")
    results.round(3).to_csv(p, index=False)
    written.append(p)

    loadings = pca.components_.T * np.sqrt(pca.explained_variance_)
    p = os.path.join(dirpath_tables, file_prefix + "loading_matrix.csv")
    pd.DataFrame(np.round(loadings, 2), columns=label_pc,
                 index=features).to_csv(p)
    written.append(p)
    p = os.path.join(dirpath_tables, file_prefix + "corr_matrix.csv")
    pd.DataFrame(np.round(np.transpose(pca.components_), 2),
                 columns=label_pc, index=features).to_csv(p)
    written.append(p)
    return written, pca, coor, results


def pca_procedure(dataset: pd.DataFrame, features, to_describe,
                  dirpath_tables="tables", dirpath_images="images",
                  file_prefix="PCA_", title_graph="PCA", device="cuda",
                  figures: bool = True) -> list[str]:
    """The whole procedure: the values CSV, the component-selection figure,
    the loading and correlation matrices and the individuals' and
    variables' plots, in the reference's order. With ``figures`` off, the
    tables alone (no matplotlib needed)."""
    if not file_prefix.endswith("_"):
        file_prefix += "_"
    tables, pca, coor, results = pca_tables(
        dataset, features, to_describe, dirpath_tables, file_prefix, device)
    if not figures:
        return tables
    import matplotlib.pyplot as plt

    written = tables[:1]
    ensure_dir_exists(dirpath_images)
    ev = pca.explained_variance_
    bsm, fig = evplot(ev)
    pc_to_plot = min(determine_pc_num(ev, bsm), coor.shape[1])
    p = os.path.join(dirpath_images, file_prefix + "PC_to_keep_evplot.jpg")
    fig.savefig(p, bbox_inches="tight")
    plt.close(fig)
    written.append(p)
    written += tables[1:]

    targets = dataset[to_describe].unique().tolist()
    written.extend(plot_pca(coor, results, pca, features, targets,
                            to_describe, pc_to_plot, dirpath_images,
                            file_prefix, title_graph))
    return written
