"""Configuration structs and frozen algorithm constants.

Defaults mirror the reference CLI (reference:src/utils.rs:54-84,
reference:src/types.rs:97-113): k=21, scaled=1500, D=4096, seed=123,
canonical=True, ani_threshold=85.0, method="t1ha2".
"""

from __future__ import annotations

import dataclasses
from pathlib import Path

VERSION = "0.1.0"

CMD_SKETCH = "sketch"
CMD_DIST = "dist"
CMD_SEARCH = "search"

U64_MASK = (1 << 64) - 1
U32_MASK = (1 << 32) - 1

# --- t1ha2 primes (reference:src/cuda_kernel.cu:71-77) ---------------------
T1HA_PRIME_0 = 0xEC99BF0D8372CAAB
T1HA_PRIME_1 = 0x82434FE90EDCEF39
T1HA_PRIME_2 = 0xD4F06DB99D67BE4B
T1HA_PRIME_3 = 0xBD9CACC22C6E9571
T1HA_PRIME_4 = 0x9C06FAF4D023E3AB
T1HA_PRIME_5 = 0xC060724A8424F345
T1HA_PRIME_6 = 0xCB5AF53AE3AAAC31

# --- wyhash v1 (wyhash crate 0.5.0) constants used by WyRng ----------------
# wyrng(seed): seed += WY_P0; return wymum(seed ^ WY_P1, seed)
# where wymum(a, b) = hi64(a*b) ^ lo64(a*b).
# The reference seeds WyRng::seed_from_u64(hash) per sampled k-mer hash
# (reference:src/hd.rs:100) and draws D/64 next_u64() words.
WY_P0 = 0xA0761D6478BD642F
WY_P1 = 0xE7037ED1A0B428DB

# FracMinHash keeps h iff h < U64_MAX / scaled (reference:src/types.rs:180,
# reference:src/sketch.rs:73). Integer floor division.
def fracminhash_threshold(scaled: int) -> int:
    return U64_MASK // scaled


# Lossless HV quantization searches bit widths in [6, 16]
# (reference:src/hd.rs:123-136).
QUANT_BITS_MIN = 6
QUANT_BITS_MAX = 16

# ASCII codes for canonical bases; lexicographic ASCII order == 2-bit code
# order (A<C<G<T), which lets the device pick canonical strands by numeric
# comparison of 2-bit packed k-mers (reference:src/cuda_kernel.cu:302-311
# does a bytewise strcmp; equivalent for ACGT).
BASE_ASCII = (65, 67, 71, 84)  # A C G T


@dataclasses.dataclass
class SketchParams:
    """Sketch-mode configuration (reference:src/types.rs:83-131)."""

    path: Path = Path()
    out_file: Path = Path()
    sketch_method: str = "t1ha2"
    canonical: bool = True
    device: str = "cuda"
    ksize: int = 21
    seed: int = 123
    scaled: int = 1500
    hv_d: int = 4096
    hv_quant_scale: float = 1.0
    if_compressed: bool = True
    threads: int = 16

    @property
    def threshold(self) -> int:
        return fracminhash_threshold(self.scaled)

    def validate(self) -> None:
        if not 1 <= self.ksize <= 32:
            # deliberate divergence from the reference, whose CPU path
            # accepts any u8 ksize via arbitrary-length t1ha2 over ASCII
            # k-mers (reference:src/sketch.rs:90, src/types.rs:64): the
            # device kernels roll the canonical k-mer as one 2-bit-packed
            # 64-bit key, which caps k at 32. Documented in PARITY.md
            # "Known divergences"; genomic practice (and every reference
            # default/example) uses k <= 32.
            raise ValueError(
                f"ksize must be in [1, 32], got {self.ksize}: the "
                "PyTorch port's kernels roll each canonical k-mer as one "
                "64-bit 2-bit-encoded key on the device; the reference CPU "
                "path allows larger k (see PARITY.md, known divergences)"
            )
        # compression packs 256-lane blocks (reference:src/hd.rs:139-153,
        # BitPacker8x::BLOCK_LEN); anything coarser passes validation but
        # dies at dump time, so reject it here
        if self.hv_d < 256 or self.hv_d % 256 != 0:
            # hv_d=0 and negative multiples satisfy a bare % check (Python
            # modulo) and produce structurally-valid but empty sketches
            raise ValueError(
                f"hv_d must be a positive multiple of 256, got {self.hv_d}"
            )
        if not 1 <= self.scaled <= U64_MASK:
            # scaled > u64::MAX makes the FracMinHash threshold 0: every
            # sketch silently empty
            raise ValueError(
                f"scaled must be in [1, 2^64-1], got {self.scaled}"
            )


@dataclasses.dataclass
class DistParams:
    """Dist/search-mode configuration (reference:src/types.rs:237-272)."""

    path_ref_sketch: Path = Path()
    path_query_sketch: Path = Path()
    out_file: Path = Path()
    ksize: int = 21
    hv_d: int = 4096
    ani_threshold: float = 85.0
    # search-mode extension (reference leaves `search` as a TODO stub,
    # reference:src/main.rs:22-24); we implement it as dist-with-top-k.
    top_k: int = 0  # 0 = report all pairs above threshold
