"""tests/tiny_model.TinySeg in the port's layers, with the same parameter
names, so one set of weights loads into both (`params_from_jax`), and the
same sync-BN axis (`bn_axis_name`); under a spatial context it upsamples
to the images' global height (`parallel/spatial.py`), and under a task
axis it takes [T, B, H, W, 3] images in the folded layout
(`layers.task_axis`)."""
import torch
import torch.nn as nn

from mliis_tpu_torch.models import layers
from mliis_tpu_torch.ops.resize import resize_bilinear_align_corners_nchw
from mliis_tpu_torch.parallel import spatial


class TorchTinySeg(nn.Module):

    def __init__(self, n_output_channels: int = 2, features: int = 8,
                 final_layer_dropout_rate=0.0, bn_axis_name=None):
        super().__init__()
        self.final_layer_dropout_rate = final_layer_dropout_rate
        self.bn_axis_name = bn_axis_name
        self.conv0 = layers.Conv2d(3, features, 3, stride=2, use_bias=False)
        self.batch_normalization = layers.FusedBatchNorm(
            features, axis_name=bn_axis_name)
        self.conv1 = layers.Conv2d(features, features, 3, use_bias=False)
        self.batch_normalization_1 = layers.FusedBatchNorm(
            features, axis_name=bn_axis_name)
        self.final_layer_weights = layers.Conv2d(features, n_output_channels,
                                                 1)

    def forward(self, images, train=True, final_layer_dropout_rate=None,
                generator=None, upsample=True):
        x = layers.fold_nhwc(images / 255.0)
        x = layers.swish(self.batch_normalization(self.conv0(x), train))
        x = layers.swish(self.batch_normalization_1(self.conv1(x), train))
        rate = final_layer_dropout_rate
        if rate is None:
            rate = self.final_layer_dropout_rate
        if rate and train:
            x = layers.traced_dropout(generator, x, rate)
        x = self.final_layer_weights(x)
        if not upsample:
            return x, None
        logits = layers.unfold_nchw(resize_bilinear_align_corners_nchw(
            x, spatial.global_height(images, images.ndim - 3),
            images.shape[-2]))
        return logits, torch.softmax(logits, dim=-1)
