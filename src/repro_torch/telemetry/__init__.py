"""Telemetry of the PyTorch port.  Only the load signal the fleet layer
reads is here (:mod:`repro_torch.telemetry.load`); the bridges, the trace
rings and the timeline of the reference's ``repro.telemetry`` are not
ported yet (ROADMAP Queue A 8)."""
