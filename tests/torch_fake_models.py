"""Stand-ins for the extraction's two models: exact, cheap functions of a
batch's clips, each row's taps depending on its own clip alone, so that
extraction runs can be compared row for row on any device and batch layout."""

from collections import OrderedDict

import torch


class FakeVideo(torch.nn.Module):
    media_type = "video"
    model_tag = {"name": "FakeVid", "dataset": "synthetic"}

    def forward(self, frames):
        x = frames.float()
        return [x.mean(dim=(1, 2, 3)), x.flatten(1)[:, ::97][:, :64]]


class FakeAudio(torch.nn.Module):
    media_type = "audio"
    model_tag = {"name": "FakeAud", "dataset": "synthetic"}

    def forward(self, audio, valid_samples):
        return [audio[:, ::4001], valid_samples.float()[:, None]]


def fake_models(device="cpu"):
    return OrderedDict([("layer_vggish", FakeAudio().to(device)),
                        ("layer_slowfast", FakeVideo().to(device))])
