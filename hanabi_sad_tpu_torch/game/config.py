"""Static game configuration (counterpart of `hanabi_sad_tpu/game/config.py`).

Players, hand size and bomb, plus the fixed Hanabi constants. Every field is
a Python int.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

NUM_COLORS = 5
NUM_RANKS = 5
# Copies of each rank per color: rank 0 has 3 copies, ranks 1-3 have 2, rank 4 has 1.
CARDS_PER_RANK: Tuple[int, ...] = (3, 2, 2, 2, 1)
DECK_SIZE = NUM_COLORS * sum(CARDS_PER_RANK)  # 50
MAX_INFO_TOKENS = 8
MAX_LIFE_TOKENS = 3
MAX_SCORE = NUM_COLORS * NUM_RANKS  # 25


def default_hand_size(players: int) -> int:
    """HLE default: 5 cards for 2-3 players, 4 for 4-5 players."""
    return 5 if players <= 3 else 4


@dataclasses.dataclass(frozen=True)
class GameConfig:
    """Hanabi game parameters.

    bomb: number of life tokens already used at game start.
    """

    players: int = 2
    hand_size: int = 5
    bomb: int = 0

    num_colors: int = NUM_COLORS
    num_ranks: int = NUM_RANKS
    max_info_tokens: int = MAX_INFO_TOKENS
    max_life_tokens: int = MAX_LIFE_TOKENS

    def __post_init__(self):
        if not 2 <= self.players <= 5:
            raise ValueError("Hanabi supports 2-5 players")
        if not 1 <= self.hand_size <= 5:
            raise ValueError("hand_size must be in [1, 5]")
        if not 0 <= self.bomb < self.max_life_tokens:
            raise ValueError("bomb must be in [0, max_life_tokens)")

    @property
    def deck_size(self) -> int:
        return self.num_colors * sum(CARDS_PER_RANK[: self.num_ranks])

    @property
    def num_cards(self) -> int:
        """Distinct card types."""
        return self.num_colors * self.num_ranks

    @property
    def start_life(self) -> int:
        return self.max_life_tokens - self.bomb

    @property
    def max_score(self) -> int:
        return self.num_colors * self.num_ranks

    # Move-uid layout, identical to HLE: discard, play, reveal-color, reveal-rank.
    @property
    def max_moves(self) -> int:
        return 2 * self.hand_size + (self.players - 1) * (
            self.num_colors + self.num_ranks
        )

    @property
    def num_actions(self) -> int:
        """max_moves + 1; the extra uid is the no-op used when a player has no
        legal moves."""
        return self.max_moves + 1

    @property
    def no_op_uid(self) -> int:
        return self.max_moves

    # ---- canonical encoder section sizes ----

    @property
    def hands_section(self) -> int:
        return self.players * (self.hand_size * self.num_cards + 1)

    @property
    def board_section(self) -> int:
        deck_therm = self.deck_size - self.players * self.hand_size
        return (
            deck_therm + self.num_cards + self.max_info_tokens + self.max_life_tokens
        )

    @property
    def discard_section(self) -> int:
        return self.num_colors * sum(CARDS_PER_RANK[: self.num_ranks])

    @property
    def last_action_section(self) -> int:
        # acting player P + move type 4 + target player P + color C + rank R
        # + reveal outcome H + position H + card CR + scored 1 + info-added 1
        return (
            2 * self.players
            + 4
            + self.num_colors
            + self.num_ranks
            + 2 * self.hand_size
            + self.num_cards
            + 2
        )

    @property
    def knowledge_section(self) -> int:
        return self.players * self.hand_size * (
            self.num_cards + self.num_colors + self.num_ranks
        )

    @property
    def obs_dim(self) -> int:
        """Per-player observation size without the SAD channel (783 for 2p)."""
        return (
            self.hands_section
            + self.board_section
            + self.discard_section
            + self.last_action_section
            + self.knowledge_section
        )

    def feature_size(self, sad: bool) -> int:
        """Model input size; SAD appends a second last-action block encoding
        the partner's greedy action (838 for 2p)."""
        return self.obs_dim + (self.last_action_section if sad else 0)

    @property
    def hand_feature_size(self) -> int:
        """Aux-task target size per player: hand_size trinary slots."""
        return self.hand_size * 3
