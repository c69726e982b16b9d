from .data_model import (MinuTemplate, TextureTemplate, Template,
                         MatcherConstants)
from .codec import (read_final_template, write_final_latent_template,
                    write_final_rolled_pq_template, read_codebook,
                    write_codebook, read_template, write_template,
                    run_length_encode, run_length_decode)
from .packing import (PackedLatent, PackedGallery, pack_latent, pack_gallery,
                      pack_rolled_entry, repad_latent)

__all__ = [
    "MinuTemplate", "TextureTemplate", "Template", "MatcherConstants",
    "read_final_template", "write_final_latent_template",
    "write_final_rolled_pq_template", "read_codebook", "write_codebook",
    "read_template", "write_template", "run_length_encode",
    "run_length_decode",
    "PackedLatent", "PackedGallery", "pack_latent", "pack_gallery",
    "pack_rolled_entry", "repad_latent",
]
