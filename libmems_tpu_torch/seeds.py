"""Spaced-seed patterns and defaults.

Functional equivalent of libMems/SeedMasks.h: palindromic spaced-seed
patterns of weights 3-21 from Darling, Treangen, Zhang, Kuiken, Messeguer,
Perna, "Procrastination leads to efficient match filtration for local
multiple alignment", LNBI 4175:126-137 (2006), plus solid seeds for
weights >= 22.  The pattern integers below are the published constants
(reference: libMems/SeedMasks.h:44-260); a seed pattern is a bitmask whose
set bits select which positions of a window participate in the seed.

Default seed-weight selection matches libMems/SeedMasks.h:389-401:
``ceil(log2(avg_len)/1.5)`` forced odd, clamped to [5, 31].
"""

from __future__ import annotations

import math

CODING_SEED = 3
SOLID_SEED = (1 << 31) - 1  # sentinel rank meaning "use a solid seed"

MIN_DNA_SEED_WEIGHT = 5
MAX_DNA_SEED_WEIGHT = 31

# weight -> list of seed patterns, ordered by sensitivity rank.
# Patterns are the published constants from Darling et al. 2006
# (cf. libMems/SeedMasks.h seedMasks()).
_SPACED_SEEDS: dict[int, list[int]] = {
    3: [0b1011],
    4: [0b101011],
    5: [0b1101011, 0b100111001, 0b110010011, 0b1101011],
    6: [0b10110001101, 0b11001010011, 0b110101011, 0b11011011],
    7: [0b1100101010011, 0b101100010001101, 0b110100010001011, 0b101111101,
        0b1011001001101],
    8: [0b11100100100111, 0b1110010100111, 0b110010101010011, 0b101101101101],
    9: [0b111010010010111, 0b11100100100100111, 0b111001010100111,
        0b11011111011, 0b1011011101101],
    10: [0b11101001010010111, 0b111010010010010111, 0b1110100110010111,
         0b110110101011011],
    11: [0b11110010101001111, 0b1110101001001010111, 0b111001001010100100111,
         0b101101111101101, 0b1011011001001101101],
    12: [0b1111001010101001111, 0b111101001100101111, 0b1110110100010110111,
         0b1011011010101101101],
    13: [0b11110010010101001001111, 0b111010110010011010111,
         0b111010011010110010111, 0b11011011111011011, 0b1110101101011010111],
    14: [0b111100110101011001111, 0b11110101100110101111,
         0b1111010100110010101111, 0b1101011010110101101011],
    15: [0b11110101100100110101111, 0b11110110010101001101111,
         0b11110011010101011001111, 0b101101101111101101101,
         0b11010110101110101101011],
    16: [0b111101011001100110101111, 0b111011100101101001110111,
         0b11111001101010110011111, 0b111010110101101011010111],
    17: [0b11011011011111011011011],
    18: [0b11111001101011010110011111, 0b11111010110011001101011111,
         0b111101100110101011001101111],
    19: [0b111101110010111010011101111, 0b111110101100111001101011111,
         0b1111011011101011101101111],
    20: [0b11111010110011011001101011111, 0b11111011011100111011011111,
         0b1111101011100110011101011111],
    21: [0b111110111011010110111011111, 0b11111100110101110101100111111,
         0b111111010110111011010111111],
}

# NOTE: libMems/SeedMasks.h:102,117,132,144 tag the weight-11/13/15/17
# rank-3 patterns as "coding patterns" (every third position); CODING_SEED=3
# selects them via getSeed(weight, CODING_SEED).


def solid_seed(weight: int) -> int:
    """A contiguous (solid) seed of the given weight (SeedMasks.h:276-281)."""
    return (1 << weight) - 1


def get_seed(weight: int, seed_rank: int = 0) -> int:
    """Return the seed pattern of the given weight and sensitivity rank.

    Mirrors libMems/SeedMasks.h:298-321: rank==SOLID_SEED or rank>5 or an
    absent pattern fall back to a solid seed; weight>31 returns solid 32.
    """
    if seed_rank == SOLID_SEED:
        return solid_seed(weight)
    if weight > 31:
        return solid_seed(32)
    if seed_rank > 5:
        return solid_seed(weight)
    pats = _SPACED_SEEDS.get(weight)
    if pats is None or seed_rank >= len(pats) or pats[seed_rank] == 0:
        return solid_seed(weight)
    return pats[seed_rank]


def seed_length(seed: int) -> int:
    """Span in window positions from lowest to highest set bit (SeedMasks.h:335-350)."""
    if seed == 0:
        return 0
    return seed.bit_length() - (seed & -seed).bit_length() + 1


def seed_weight(seed: int) -> int:
    """Number of set bits (SeedMasks.h:363-373)."""
    return bin(seed).count("1")


def default_seed_weight(avg_sequence_length: int) -> int:
    """Default seed weight for a given average sequence length.

    Mirrors libMems/SeedMasks.h:389-401: ceil(log2(len)/1.5), forced odd,
    0 if below the minimum weight of 5, clamped to 31.
    """
    if avg_sequence_length == 0:
        return 0
    w = math.ceil((math.log(float(avg_sequence_length)) / math.log(2.0)) / 1.5)
    if not (w & 1):
        w += 1
    if w < MIN_DNA_SEED_WEIGHT:
        return 0
    return min(w, MAX_DNA_SEED_WEIGHT)


def seed_offsets(seed: int) -> list[int]:
    """Offsets (0 = leftmost window position) of the seed's sampled positions.

    The reference walks the pattern MSB-first when assembling a seed mer
    (libMems/SortedMerList.cpp:726-762 GetSeedMer): bit (seed_length-1) of
    the pattern corresponds to the first (leftmost) character of the window.
    """
    length = seed_length(seed)
    return [length - 1 - b for b in range(length - 1, -1, -1) if (seed >> b) & 1]
