"""Visualisation: skeleton, heatmap and box drawing (host-side, cv2).  The
clinical figures (matplotlib) are not ported yet (ROADMAP Queue 1 item
8)."""

from .skeleton import (create_grid_image, draw_bbox, draw_heatmaps,
                       draw_skeleton, keypoint_color)

__all__ = ["create_grid_image", "draw_bbox", "draw_heatmaps",
           "draw_skeleton", "keypoint_color"]
