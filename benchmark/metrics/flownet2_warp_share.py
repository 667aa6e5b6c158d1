"""The glue between FlowNet 2.0's networks: the device time of the port's
``flownet2.warp`` spans (``models/flownet2.py``: each of the four warp
blocks, resample, difference, channel norm and the upsample and
concatenation that feed the next network, timed by CUDA events on the
stream) over that of its ``flow.extract`` spans (``eval/infer.py``), in
the traced segment, as a share.  None where the program has no such
spans."""


def read(r):
    if r.trace is None:
        return None
    try:
        from ammcnet_aaai2021_torch.utils.profiling import summary
    except ImportError:
        return None
    s = summary()
    warp, extract = s.get("flownet2.warp"), s.get("flow.extract")
    if (not warp or not extract or warp["device_s"] is None
            or not extract["device_s"]):
        return None
    return 100.0 * warp["device_s"] / extract["device_s"]
