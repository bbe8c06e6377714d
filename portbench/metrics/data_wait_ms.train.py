"""The data pipeline's wait per step: the host seconds the step loop
spent in ``PrefetchPipeline.__next__`` (the pipeline's own ``wait_s``)
over the traced window's steps, in milliseconds."""


def read(ctx, res, summary):
  if "data_wait_s" not in res or not res.get("units"):
    return None
  return 1000.0 * res["data_wait_s"] / res["units"]
