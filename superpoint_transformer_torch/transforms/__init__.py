"""Host transforms: the preprocessing chain (raw cloud -> NAG) and the
per-batch transforms and padding (NAGs -> padded batch)."""
