"""How a one-shot call's rows fall on the cards: the batch padded (the last
row repeated) to a multiple of the card count and split into contiguous
rows, as a pipeline over several cards splits it."""


def per_card(rows, cards: int):
    if cards <= 1:
        return [rows]
    rows = list(rows) + [rows[-1]] * (-len(rows) % cards)
    n = len(rows) // cards
    return [rows[i * n:(i + 1) * n] for i in range(cards)]
