"""pad_share.serve: the share of the prefilled tokens that are padding,
counted from the window's rounds: each round prefills its slots at its
longest prompt."""


def read(rec):
    if rec.kind != "serve" or not rec.rounds:
        return None
    filled = sum(slots * padded for slots, padded, _ in rec.rounds)
    useful = sum(sum(lens) for _, _, lens in rec.rounds)
    return 100.0 * (filled - useful) / filled
