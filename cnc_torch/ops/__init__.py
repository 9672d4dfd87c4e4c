"""Tensor ops: hashing, STE quantizers, SH/sine embeddings, the hash-grid
encode (K1), stream compaction (K3) and segment scans."""
