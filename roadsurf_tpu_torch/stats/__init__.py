"""The statistical branch's toolkit (a copy of the reference package's
``stats/``): descriptive statistics with margins of error, density
histograms, the PCA with Kaiser / broken-stick component selection (the
decomposition in PyTorch, float64, on a chosen device) and masked pixel
extraction / zonal statistics."""

from .descriptive import (compare_histograms, get_df_stats_groupby,
                          get_df_stats_no_group)
from .pca import calculate_pca, determine_pc_num, evplot, pca_procedure
from .pixels import get_pixel_values, zonal_stats

__all__ = [
    "compare_histograms", "get_df_stats_groupby", "get_df_stats_no_group",
    "evplot", "determine_pc_num", "calculate_pca", "pca_procedure",
    "get_pixel_values", "zonal_stats",
]
