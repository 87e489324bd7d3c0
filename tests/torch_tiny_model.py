"""tests/tiny_model.TinySeg in the port's layers, with the same parameter
names, so one set of weights loads into both (`params_from_jax`)."""
import torch
import torch.nn as nn

from mliis_tpu_torch.models import layers
from mliis_tpu_torch.ops.resize import resize_bilinear_align_corners_nchw


class TorchTinySeg(nn.Module):

    def __init__(self, n_output_channels: int = 2, features: int = 8,
                 final_layer_dropout_rate=0.0):
        super().__init__()
        self.final_layer_dropout_rate = final_layer_dropout_rate
        self.conv0 = layers.Conv2d(3, features, 3, stride=2, use_bias=False)
        self.batch_normalization = layers.FusedBatchNorm(features)
        self.conv1 = layers.Conv2d(features, features, 3, use_bias=False)
        self.batch_normalization_1 = layers.FusedBatchNorm(features)
        self.final_layer_weights = layers.Conv2d(features, n_output_channels,
                                                 1)

    def forward(self, images, train=True, final_layer_dropout_rate=None,
                generator=None, upsample=True):
        x = (images / 255.0).permute(0, 3, 1, 2)
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
        logits = resize_bilinear_align_corners_nchw(
            x, images.shape[1], images.shape[2]).permute(0, 2, 3, 1)
        return logits, torch.softmax(logits, dim=-1)
