"""Operations and bytes that each counted function needs for given
inputs, at their real node and edge counts (no padding, no rounding),
and the card's published peaks."""
