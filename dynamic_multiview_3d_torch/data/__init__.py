"""Data: the sources (the synthetic scene bank, frame folders, tfrecords,
ShapeNet renderings), the stream iterator, the device-resident bank and
in-step preprocessing."""

from dynamic_multiview_3d_torch.data.frames import (FrameFolderScenes,
                                                    SyntheticFrames)
from dynamic_multiview_3d_torch.data.pipeline import (make_source,
                                                      make_stream_iterator)
from dynamic_multiview_3d_torch.data.resident import ResidentFrames
from dynamic_multiview_3d_torch.data.shapenet import ShapeNetDirScenes
from dynamic_multiview_3d_torch.data.synthetic import SyntheticScenes
from dynamic_multiview_3d_torch.data.tfrecords import TFRecordScenes

__all__ = ["FrameFolderScenes", "ResidentFrames", "ShapeNetDirScenes",
           "SyntheticFrames", "SyntheticScenes", "TFRecordScenes",
           "make_source", "make_stream_iterator"]
