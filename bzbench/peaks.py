"""Published peaks of the cards a run may report, by the name that
``torch.cuda.get_device_name()`` gives (NVIDIA's data sheets; SXM parts at
their full power limit)."""

HBM_BYTES_PER_S = {
    "NVIDIA H100 80GB HBM3": 3.35e12,
}
