from .attention import (flash_attention_partials,
                        flash_attention_partials_reference, flash_mha)

__all__ = ["flash_attention_partials", "flash_attention_partials_reference",
           "flash_mha"]
