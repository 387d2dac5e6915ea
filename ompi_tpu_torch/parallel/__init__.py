from .ring import attention_reference

__all__ = ["attention_reference"]
