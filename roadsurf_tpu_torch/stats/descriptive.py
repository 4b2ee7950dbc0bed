"""Descriptive statistics of pixel values (a copy of the reference
package's ``stats/descriptive.py``, the upstream fct_statistics.py): density
histograms of pixel sets, and per-group or whole-column min, max, median,
mean, count and std with the 95% margin of error 2·std/√n. pandas and
matplotlib."""

from __future__ import annotations

import numpy as np
import pandas as pd


def compare_histograms(data: dict, graph_title: str | None = None,
                       axis_label: str | None = None):
    """Density histograms of two or more pixel sets on one figure, bins
    linspace(0, 255, 55)."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    bins = np.linspace(0, 255, 55)
    fig = plt.figure()
    ax = fig.add_subplot(1, 1, 1)
    for label, values in data.items():
        ax.hist(values, bins, alpha=0.3, label=str(label), density=True)
    ax.legend(loc="upper right")
    ax.grid()
    ax.set(title=graph_title, ylabel=axis_label)
    return fig


def get_df_stats_groupby(dataframe: pd.DataFrame, col: str, groups,
                         suffix: str = "") -> pd.DataFrame:
    """min/max/median/mean/count/std of ``col`` per group, with the 95%
    margin of error 2·std/√n."""
    stats = dataframe.groupby(groups)[col].agg(
        ["min", "max", "median", "mean", "count", "std"])
    Z = 2  # 1.96 rounded up
    stats[f"margin{suffix}"] = Z * stats["std"] / np.sqrt(stats["count"])
    stats["mean"] = stats["mean"].round(2)
    stats["std"] = stats["std"].round(2)
    stats[f"margin{suffix}"] = stats[f"margin{suffix}"].round(2)
    if suffix:
        stats.rename(columns={k: f"{k}{suffix}" for k in
                              ["min", "max", "median", "mean", "count",
                               "std"]}, inplace=True)
    return stats


def get_df_stats_no_group(dataframe: pd.DataFrame, col: str,
                          results_dict: dict | None = None,
                          suffix: str = "", to_df: bool = False):
    """Whole-column statistics of ``col`` appended to a running dict (a
    frame of it with ``to_df``)."""
    if results_dict is None:
        results_dict = {f"{k}{suffix}": [] for k in
                        ["min", "max", "mean", "median", "std", "count",
                         "margin"]}
    s = dataframe[col]
    results_dict[f"min{suffix}"].append(int(s.min()))
    results_dict[f"max{suffix}"].append(int(s.max()))
    results_dict[f"mean{suffix}"].append(round(s.mean(), 2))
    results_dict[f"median{suffix}"].append(s.median())
    results_dict[f"std{suffix}"].append(round(s.std(), 2))
    results_dict[f"count{suffix}"].append(int(s.count()))
    Z = 2
    results_dict[f"margin{suffix}"].append(np.round(
        Z * results_dict[f"std{suffix}"][-1]
        / np.sqrt(results_dict[f"count{suffix}"][-1]), decimals=3))
    if to_df:
        return pd.DataFrame(results_dict)
    return results_dict
