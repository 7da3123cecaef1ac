"""The part of a window round that no round phase covers: the mean round
time (host clock around each round) less the mean of the program's
`round.*` spans (`MultiSystem._round`'s phases, each recorded in every
lane's table with its full time, so their sum over the systems is divided
by lanes x rounds). Absent from a program without the spans."""

LAYER = 'fleet (system/multi.MultiSystem)'
UNIT = 'ms'
SOURCE = 'program_span'
MOVES = 'fleet_fps'


def read(ctx):
    spanned = [v for k, v in ctx["stage_s"].items()
               if k.startswith("round.")]
    if not spanned or not ctx["round_s"]:
        return None
    mean = sum(ctx["round_s"]) / len(ctx["round_s"])
    return 1000.0 * (mean - sum(spanned) / (ctx["lanes"] * ctx["rounds"]))
