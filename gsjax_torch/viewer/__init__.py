"""Viewers of a model: the SIBR remote-viewer TCP bridge (``network_gui``)
and the local web viewer (``local_viewer``)."""

from gsjax_torch.viewer.local_viewer import LocalViewer, viewer_from_model
from gsjax_torch.viewer.network_gui import ViewerBridge

__all__ = ["LocalViewer", "ViewerBridge", "viewer_from_model"]
