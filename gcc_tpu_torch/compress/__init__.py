"""MACs counting and structured pruning to a MACs budget (port of
gcc_tpu/compress): stage 2 of the three-stage workflow."""

from gcc_tpu_torch.compress.macs import (  # noqa: F401
    conv_macs, unet_macs, mobile_resnet_macs, sagan_macs, srresnet_macs,
    count_params,
)
from gcc_tpu_torch.compress.prune import (  # noqa: F401
    binary_search_threshold, prune_unet, prune_mobile_resnet,
    prune_mobile_resnet_union, prune_sagan, prune_srresnet,
    cyclegan_reference_cfgs, tolerance_for,
)
