from .data_model import (MinuTemplate, TextureTemplate, Template,
                         MatcherConstants)
from .codec import (read_final_template, write_final_latent_template,
                    write_final_rolled_pq_template, read_codebook,
                    write_codebook)
from .packing import (PackedLatent, PackedGallery, pack_latent, pack_gallery,
                      pack_rolled_entry)

__all__ = [
    "MinuTemplate", "TextureTemplate", "Template", "MatcherConstants",
    "read_final_template", "write_final_latent_template",
    "write_final_rolled_pq_template", "read_codebook", "write_codebook",
    "PackedLatent", "PackedGallery", "pack_latent", "pack_gallery",
    "pack_rolled_entry",
]
