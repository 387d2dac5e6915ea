from .collectives import DeviceComm
from .device_plane import device_plane_active, init_device_plane
from .mesh import classify_axes, make_mesh
from .ring import attention_reference, ring_attention

__all__ = ["DeviceComm", "attention_reference", "classify_axes",
           "device_plane_active", "init_device_plane", "make_mesh",
           "ring_attention"]
