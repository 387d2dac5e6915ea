from .attention import (flash_attention, flash_attention_partials,
                        flash_attention_partials_reference,
                        flash_attention_reference, flash_mha)

__all__ = ["flash_attention", "flash_attention_partials",
           "flash_attention_partials_reference", "flash_attention_reference",
           "flash_mha"]
