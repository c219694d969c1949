from stf_unet_tpu_torch.viz.overlay import merge_images, save_overlay
from stf_unet_tpu_torch.viz.comparison import save_comparison, save_predictions
from stf_unet_tpu_torch.viz.tic import visualize_sequence, plot_mask_center_tic, plot_masked_time_intensity_curve

__all__ = [
    "merge_images",
    "save_overlay",
    "save_comparison",
    "save_predictions",
    "visualize_sequence",
    "plot_mask_center_tic",
    "plot_masked_time_intensity_curve",
]
