from fastposecnn_tpu_torch.models.resnet import ResNetEncoder  # noqa: F401
from fastposecnn_tpu_torch.models.fpn import FPNDecoder, SegmentationHead  # noqa: F401
from fastposecnn_tpu_torch.models.pose_regressor import PoseRegressorNet, network_from_hparams  # noqa: F401
