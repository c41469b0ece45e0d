"""Visualisation: skeleton, heatmap and box drawing (host-side, cv2), and
the infant clinical figures and video overlay (viz/clinical.py;
matplotlib, imported when a figure is drawn)."""

from .clinical import (create_clinical_report_figure,
                       create_video_with_pose, plot_confidence_over_time,
                       plot_joint_position_heatmaps, plot_movement_trajectory,
                       plot_pseudo_3d_pose)
from .skeleton import (create_grid_image, draw_bbox, draw_heatmaps,
                       draw_skeleton, keypoint_color)

__all__ = ["create_clinical_report_figure", "create_grid_image",
           "create_video_with_pose", "draw_bbox", "draw_heatmaps",
           "draw_skeleton", "keypoint_color", "plot_confidence_over_time",
           "plot_joint_position_heatmaps", "plot_movement_trajectory",
           "plot_pseudo_3d_pose"]
