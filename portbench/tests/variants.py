"""Model variants the tests build from a shipped configuration, defined
once for every test module."""

# EfficientLab-b3's model keys: EfficientNet-b3 cut at block 17, decoder
# width 136 (no file of configs/ holds it yet; once one does, build the
# variant from that file).
B3 = {"backbone": "efficientnet-b3", "max_block": 17, "decoder_dim": 136}
