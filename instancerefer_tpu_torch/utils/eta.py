"""ETA decomposition, counterpart of ``instancerefer_tpu/utils/eta.py``."""


def decode_eta(eta_sec: float) -> dict:
    eta_sec = max(int(eta_sec), 0)
    return {
        "h": eta_sec // 3600,
        "m": (eta_sec % 3600) // 60,
        "s": eta_sec % 60,
    }
