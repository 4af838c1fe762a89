"""Model API and nets: the share of the nets' work the tiling does twice,
in %: the positions the encoder's and the decoder's calls ran on, each
net's over the positions of the input it covers (its clip or latent),
averaged over the two nets, less one.  Counted in pixels, that is the
two nets' positions over twice the clip's pixels, less one.  From the
tile counters in the port's request records."""

from benchmark.metrics.queue_wait_ms import traced_records

NETS = ("encoder", "decoder")


def read(tr):
    recs = traced_records()
    if not recs:
        return None
    ratios = []
    for net in NETS:
        ran = sum(r.tiles.get(f"{net}.positions", 0) for r in recs)
        whole = sum(r.tiles.get(f"{net}.input_positions", 0) for r in recs)
        if not whole:
            return None
        ratios.append(ran / whole)
    return 100.0 * (sum(ratios) / len(ratios) - 1.0)
