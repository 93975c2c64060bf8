"""Query bases of every request completed in the window, over the window's
seconds: ``search_kbp_per_s`` itself, reported per layer (by the service
layer) in the cells where its runs spread too widely for an end-to-end
bound, and moving the tail there. Taken by the clients' clock, as the
end-to-end metric is."""


def read(rec):
    return rec.end_to_end.get("search_kbp_per_s")
