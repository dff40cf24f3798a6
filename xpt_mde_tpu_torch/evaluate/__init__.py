from xpt_mde_tpu_torch.evaluate.depth_metrics import (DEPTH_METRIC_NAMES,
                                                      compute_depth_metrics,
                                                      valid_depth_filter)
from xpt_mde_tpu_torch.evaluate.pose_metrics import PoseMetric
