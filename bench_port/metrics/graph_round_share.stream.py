"""graph_round_share.stream: the share of the streaming solve's bidding
rounds that the card replayed from a CUDA graph, the program's counts
``stream_round_graph`` over ``stream_round_graph + stream_round_eager``
summed over the window (rounds replayed with nothing open,
``stream_round_idle``, count in neither); nothing where the program counts
no rounds."""


def read(rec):
    got = [sum(p["launches"].get(k, 0) for p in rec["pairs"])
           for k in ("stream_round_graph", "stream_round_eager")]
    return got[0] / sum(got) if sum(got) else None
