"""MPEG-4 Part 2 and H.264 decoding on the card's NVDEC engines.

The JAX package decodes these on the host through OpenCV's FFmpeg; it has
no TPU kernel for them. The port reaches the driver's video decoder
directly: `libnvcuvid.so.1` (the parser and the decoder) and `libcuda.so.1`
(the context), with ctypes. The driver ships both without development
symlinks and the toolkit holds no Video Codec SDK headers, so the layouts
of the structures that cross the boundary are declared here, once, by
hand, from the SDK's cuviddec.h / nvcuvid.h (x86-64: `unsigned long` is 8
bytes, enums 4). Structures the port allocates carry trailing reserved
space; `CUVIDPICPARAMS` passes from the parser to the decoder as an opaque
pointer.

`NvdecDecoder` is one parser and one decoder on torch's context (the
device's primary context, retained once and pushed around every call so
that any thread can drive its own decoder). The parser's callbacks create the decoder at the sequence
header (with the stream's minimum number of surfaces), decode each
picture, and at display map the picture, copy its visible NV12 planes into
tensors on torch's current stream and unmap. Each packet carries its
frame's display index as its timestamp, which the display callback gets
back, so frames are numbered by the container whatever order the decoder
shows them in. A callback never lets an exception escape into the
driver: it stores it, returns 0, and `feed` raises it once the parser has
returned. A codec the card refuses (`cuvidGetDecoderCaps`) raises
`CalibrationError` with the card's answer; nothing falls back to the CPU.
"""

from __future__ import annotations

import ctypes
import threading
from contextlib import contextmanager
from ctypes import (CFUNCTYPE, POINTER, Structure, c_int, c_longlong, c_short, c_ubyte, c_uint, c_ulong,
                    c_ulonglong, c_ushort, c_void_p)

import torch

from caliscope_tpu_torch import _cuda_build
from caliscope_tpu_torch.exceptions import CalibrationError

# cudaVideoCodec
CODECS = {"mpeg4": 2, "h264": 4, "jpeg": 5, "hevc": 8}
CHROMA_420 = 1  # cudaVideoChromaFormat_420
SURFACE_NV12 = 0  # cudaVideoSurfaceFormat_NV12
DEINTERLACE_WEAVE, DEINTERLACE_ADAPTIVE = 0, 2
CREATE_PREFER_CUVID = 4  # cudaVideoCreate_PreferCUVID: the NVDEC engines
# CUvideopacketflags
PKT_ENDOFSTREAM, PKT_TIMESTAMP, PKT_ENDOFPICTURE = 1, 2, 8


class CUVIDDECODECAPS(Structure):
    _fields_ = [
        ("eCodecType", c_int), ("eChromaFormat", c_int), ("nBitDepthMinus8", c_uint), ("reserved1", c_uint * 3),
        ("bIsSupported", c_ubyte), ("nNumNVDECs", c_ubyte), ("nOutputFormatMask", c_ushort),
        ("nMaxWidth", c_uint), ("nMaxHeight", c_uint), ("nMaxMBCount", c_uint),
        ("nMinWidth", c_ushort), ("nMinHeight", c_ushort),
        ("reserved3", c_uint * 27),  # the histogram fields and reserved words, and room to spare
    ]


class _Rect(Structure):
    _fields_ = [("left", c_int), ("top", c_int), ("right", c_int), ("bottom", c_int)]


class _ShortRect(Structure):
    _fields_ = [("left", c_short), ("top", c_short), ("right", c_short), ("bottom", c_short)]


class _SignalDescription(Structure):
    _fields_ = [
        ("video_format", c_ubyte, 3), ("video_full_range_flag", c_ubyte, 1), ("reserved_zero_bits", c_ubyte, 4),
        ("color_primaries", c_ubyte), ("transfer_characteristics", c_ubyte), ("matrix_coefficients", c_ubyte),
    ]


class CUVIDEOFORMAT(Structure):
    _fields_ = [
        ("codec", c_int), ("frame_rate_numerator", c_uint), ("frame_rate_denominator", c_uint),
        ("progressive_sequence", c_ubyte), ("bit_depth_luma_minus8", c_ubyte), ("bit_depth_chroma_minus8", c_ubyte),
        ("min_num_decode_surfaces", c_ubyte), ("coded_width", c_uint), ("coded_height", c_uint),
        ("display_area", _Rect), ("chroma_format", c_int), ("bitrate", c_uint),
        ("display_aspect_ratio_x", c_int), ("display_aspect_ratio_y", c_int),
        ("video_signal_description", _SignalDescription), ("seqhdr_data_length", c_uint),
    ]


class CUVIDDECODECREATEINFO(Structure):
    _fields_ = [
        ("ulWidth", c_ulong), ("ulHeight", c_ulong), ("ulNumDecodeSurfaces", c_ulong),
        ("CodecType", c_int), ("ChromaFormat", c_int), ("ulCreationFlags", c_ulong), ("bitDepthMinus8", c_ulong),
        ("ulIntraDecodeOnly", c_ulong), ("ulMaxWidth", c_ulong), ("ulMaxHeight", c_ulong), ("Reserved1", c_ulong),
        ("display_area", _ShortRect), ("OutputFormat", c_int), ("DeinterlaceMode", c_int),
        ("ulTargetWidth", c_ulong), ("ulTargetHeight", c_ulong), ("ulNumOutputSurfaces", c_ulong),
        ("vidLock", c_void_p), ("target_rect", _ShortRect), ("enableHistogram", c_ulong),
        ("Reserved2", c_ulong * 4), ("_spare", c_ulong * 8),
    ]


class CUVIDPARSERDISPINFO(Structure):
    _fields_ = [
        ("picture_index", c_int), ("progressive_frame", c_int), ("top_field_first", c_int),
        ("repeat_first_field", c_int), ("timestamp", c_longlong),
    ]


class CUVIDPROCPARAMS(Structure):
    _fields_ = [
        ("progressive_frame", c_int), ("second_field", c_int), ("top_field_first", c_int), ("unpaired_field", c_int),
        ("reserved_flags", c_uint), ("reserved_zero", c_uint), ("raw_input_dptr", c_ulonglong),
        ("raw_input_pitch", c_uint), ("raw_input_format", c_uint), ("raw_output_dptr", c_ulonglong),
        ("raw_output_pitch", c_uint), ("Reserved1", c_uint), ("output_stream", c_void_p),
        ("Reserved", c_uint * 46), ("histogram_dptr", c_void_p), ("Reserved2", c_void_p * 1), ("_spare", c_void_p * 8),
    ]


_SEQUENCE_CB = CFUNCTYPE(c_int, c_void_p, POINTER(CUVIDEOFORMAT))
_DECODE_CB = CFUNCTYPE(c_int, c_void_p, c_void_p)
_DISPLAY_CB = CFUNCTYPE(c_int, c_void_p, POINTER(CUVIDPARSERDISPINFO))


class CUVIDPARSERPARAMS(Structure):
    _fields_ = [
        ("CodecType", c_int), ("ulMaxNumDecodeSurfaces", c_uint), ("ulClockRate", c_uint),
        ("ulErrorThreshold", c_uint), ("ulMaxDisplayDelay", c_uint), ("uFlags", c_uint), ("uReserved1", c_uint * 4),
        ("pUserData", c_void_p), ("pfnSequenceCallback", _SEQUENCE_CB), ("pfnDecodePicture", _DECODE_CB),
        ("pfnDisplayPicture", _DISPLAY_CB), ("pfnGetOperatingPoint", c_void_p), ("pfnGetSEIMsg", c_void_p),
        ("pvReserved2", c_void_p * 5), ("pExtVideoInfo", c_void_p), ("_spare", c_void_p * 8),
    ]


class CUVIDSOURCEDATAPACKET(Structure):
    _fields_ = [("flags", c_ulong), ("payload_size", c_ulong), ("payload", c_void_p), ("timestamp", c_longlong)]


_libs: dict[str, ctypes.CDLL] = {}
_libs_lock = threading.RLock()  # guards _libs and _contexts


def _driver():
    """(libcuda, libnvcuvid), loaded once, with the signatures used here."""
    with _libs_lock:
        if _libs:
            return _libs["cuda"], _libs["cuvid"]
        try:
            cuda = ctypes.CDLL("libcuda.so.1")
            cuvid = ctypes.CDLL("libnvcuvid.so.1")
        except OSError as e:
            raise CalibrationError(
                f"NVDEC is not reachable: the driver's libcuda.so.1 / libnvcuvid.so.1 did not load ({e})"
            ) from e
        p, pp = c_void_p, POINTER(c_void_p)
        sigs = {
            (cuda, "cuDeviceGet"): [POINTER(c_int), c_int], (cuda, "cuDevicePrimaryCtxRetain"): [pp, c_int],
            (cuda, "cuCtxPushCurrent_v2"): [p], (cuda, "cuCtxPopCurrent_v2"): [pp],
            (cuda, "cuGetErrorName"): [c_int, POINTER(ctypes.c_char_p)],
            (cuvid, "cuvidGetDecoderCaps"): [POINTER(CUVIDDECODECAPS)],
            (cuvid, "cuvidCreateDecoder"): [pp, POINTER(CUVIDDECODECREATEINFO)],
            (cuvid, "cuvidDestroyDecoder"): [p], (cuvid, "cuvidDecodePicture"): [p, p],
            (cuvid, "cuvidMapVideoFrame64"): [p, c_int, POINTER(c_ulonglong), POINTER(c_uint),
                                              POINTER(CUVIDPROCPARAMS)],
            (cuvid, "cuvidUnmapVideoFrame64"): [p, c_ulonglong],
            (cuvid, "cuvidCreateVideoParser"): [pp, POINTER(CUVIDPARSERPARAMS)],
            (cuvid, "cuvidParseVideoData"): [p, POINTER(CUVIDSOURCEDATAPACKET)],
            (cuvid, "cuvidDestroyVideoParser"): [p], (cuvid, "cuvidCtxLockCreate"): [pp, p],
            (cuvid, "cuvidCtxLockDestroy"): [p],
        }
        for (lib, name), args in sigs.items():
            fn = getattr(lib, name)
            fn.argtypes, fn.restype = args, c_int
        _libs["cuda"], _libs["cuvid"] = cuda, cuvid
        return cuda, cuvid


def _error_name(result: int) -> str:
    name = ctypes.c_char_p()
    _driver()[0].cuGetErrorName(result, ctypes.byref(name))
    return (name.value or b"an unknown error").decode()


def _check(what: str, result: int) -> None:
    if result:
        raise CalibrationError(f"NVDEC: {what} failed with {_error_name(result)} ({result})")


_contexts: dict[int, int] = {}


def _context(device: torch.device) -> int:
    """torch's context on `device`: the device's primary context, which the
    CUDA runtime (and so torch) uses. It is retained once a process with
    cuDevicePrimaryCtxRetain rather than read with cuCtxGetCurrent, which
    is empty on a thread where the runtime has not yet bound it (the API's
    extraction threads)."""
    torch.cuda.init()
    index = device.index if device.index is not None else torch.cuda.current_device()
    with _libs_lock:
        if index not in _contexts:
            cuda, _ = _driver()
            ordinal, ctx = c_int(), c_void_p()
            _check("cuDeviceGet", cuda.cuDeviceGet(ctypes.byref(ordinal), index))
            _check("cuDevicePrimaryCtxRetain", cuda.cuDevicePrimaryCtxRetain(ctypes.byref(ctx), ordinal))
            if not ctx.value:
                raise CalibrationError(f"NVDEC: no primary CUDA context on {device}")
            _contexts[index] = ctx.value
        return _contexts[index]


@contextmanager
def _pushed(ctx: int):
    cuda, _ = _driver()
    _check("cuCtxPushCurrent", cuda.cuCtxPushCurrent_v2(ctx))
    try:
        yield
    finally:
        popped = c_void_p()
        cuda.cuCtxPopCurrent_v2(ctypes.byref(popped))


def decoder_caps(codec: str, device=None) -> dict:
    """What the card's NVDEC says of `codec` at 8-bit 4:2:0. A query the
    driver refuses is an answer too: `supported` False and `error` the
    driver's code (a machine whose GPU access leaves out the video engines
    answers CUDA_ERROR_OUT_OF_MEMORY for every codec)."""
    device = torch.device("cuda" if device is None else device)
    ctx = _context(device)
    caps = CUVIDDECODECAPS(eCodecType=CODECS[codec], eChromaFormat=CHROMA_420, nBitDepthMinus8=0)
    with _pushed(ctx):
        result = _driver()[1].cuvidGetDecoderCaps(ctypes.byref(caps))
    if result:
        return {"codec": codec, "supported": False, "error": f"{_error_name(result)} ({result})"}
    return {
        "codec": codec, "supported": bool(caps.bIsSupported), "nvdecs": int(caps.nNumNVDECs),
        "max_width": int(caps.nMaxWidth), "max_height": int(caps.nMaxHeight), "max_mb_count": int(caps.nMaxMBCount),
        "min_width": int(caps.nMinWidth), "min_height": int(caps.nMinHeight),
        "output_format_mask": int(caps.nOutputFormatMask),
    }


def annex_b(sample: bytes, nal_length_size: int) -> bytes:
    """An MP4 H.264 sample (length-prefixed NAL units) as an Annex B byte
    stream (each NAL after a 00 00 00 01 start code)."""
    out, at, n = [], 0, len(sample)
    while at < n:
        if at + nal_length_size > n:
            raise CalibrationError("H.264 sample ends inside a NAL length prefix")
        size = int.from_bytes(sample[at : at + nal_length_size], "big")
        at += nal_length_size
        if at + size > n:
            raise CalibrationError("H.264 NAL unit runs past the end of its sample")
        out += [b"\x00\x00\x00\x01", sample[at : at + size]]
        at += size
    return b"".join(out)


class NvdecDecoder:
    """One NVDEC parser and decoder for one track (not shared between
    threads; each FrameSource makes its own).

    feed(sample, index) hands the parser one sample in decode order, which
    will show as frame `index`; frames whose index is in `wanted` (all when
    None) are kept as (luma (H, W), chroma (H/2, W/2, 2)) uint8 tensors on
    the card and taken with `pop`. `end()` flushes the parser.
    """

    # pictures this process had NVDEC decode (cuvidDecodePicture calls)
    launches = 0

    def __init__(self, codec: str, extradata: bytes, size: tuple[int, int], device, *,
                 nal_length_size: int = 0, wanted=None):
        if codec not in ("mpeg4", "h264"):
            raise ValueError(f"NVDEC decodes 'mpeg4' and 'h264' here, not {codec!r}")
        self.device = torch.device(device)
        self.codec, self.size, self.wanted = codec, tuple(size), wanted
        self._extradata, self._nal_length_size = extradata, nal_length_size
        self._ctx = _context(self.device)
        caps = decoder_caps(codec, self.device)
        width, height = self.size
        if not caps["supported"]:
            raise CalibrationError(f"NVDEC on {torch.cuda.get_device_name(self.device)} refuses {codec} at 8-bit "
                                   f"4:2:0: cuvidGetDecoderCaps answered {caps}")
        if not (caps["min_width"] <= width <= caps["max_width"] and caps["min_height"] <= height <= caps["max_height"]):
            raise CalibrationError(f"NVDEC decodes {codec} between {caps['min_width']}x{caps['min_height']} and "
                                   f"{caps['max_width']}x{caps['max_height']}, not {width}x{height}")
        _, cuvid = _driver()
        self._cuvid = cuvid
        self.frames: dict[int, tuple[torch.Tensor, torch.Tensor]] = {}
        self.full_range = False
        self._decoder = c_void_p()
        self._format: tuple | None = None
        self._surfaces = 0
        self._error: BaseException | None = None
        self._started = False
        lock = c_void_p()
        with _pushed(self._ctx):
            _check("cuvidCtxLockCreate", cuvid.cuvidCtxLockCreate(ctypes.byref(lock), self._ctx))
        self._lock = lock
        # the callbacks must outlive the parser
        self._callbacks = (_SEQUENCE_CB(self._on_sequence), _DECODE_CB(self._on_decode),
                           _DISPLAY_CB(self._on_display))
        params = CUVIDPARSERPARAMS(CodecType=CODECS[codec], ulMaxNumDecodeSurfaces=1, ulClockRate=0,
                                   ulErrorThreshold=0, ulMaxDisplayDelay=0)
        params.pfnSequenceCallback, params.pfnDecodePicture, params.pfnDisplayPicture = self._callbacks
        self._parser = c_void_p()
        with _pushed(self._ctx):
            _check("cuvidCreateVideoParser", cuvid.cuvidCreateVideoParser(ctypes.byref(self._parser),
                                                                          ctypes.byref(params)))

    # -- the parser's callbacks (run inside cuvidParseVideoData) -------------

    def _on_sequence(self, _user, fmt_p) -> int:
        try:
            fmt = fmt_p.contents
            if fmt.bit_depth_luma_minus8 or fmt.chroma_format != CHROMA_420:
                raise CalibrationError(
                    f"NVDEC: {self.codec} at {fmt.bit_depth_luma_minus8 + 8} bits, chroma format "
                    f"{fmt.chroma_format}, is not decoded here (8-bit 4:2:0 only)")
            area = fmt.display_area
            key = (fmt.coded_width, fmt.coded_height, area.left, area.top, area.right, area.bottom)
            width, height = area.right - area.left, area.bottom - area.top
            if (width, height) != self.size:
                raise CalibrationError(f"NVDEC: the {self.codec} stream shows {width}x{height} frames but its "
                                       f"container says {self.size[0]}x{self.size[1]}")
            self.full_range = bool(fmt.video_signal_description.video_full_range_flag)
            surfaces = max(int(fmt.min_num_decode_surfaces), 1)
            if self._decoder.value and self._format == key and surfaces <= self._surfaces:
                return self._surfaces
            if self._decoder.value:
                self._cuvid.cuvidDestroyDecoder(self._decoder)
                self._decoder = c_void_p()
            info = CUVIDDECODECREATEINFO(
                ulWidth=fmt.coded_width, ulHeight=fmt.coded_height, ulNumDecodeSurfaces=surfaces,
                CodecType=fmt.codec, ChromaFormat=fmt.chroma_format, ulCreationFlags=CREATE_PREFER_CUVID,
                bitDepthMinus8=0, ulMaxWidth=fmt.coded_width, ulMaxHeight=fmt.coded_height,
                OutputFormat=SURFACE_NV12,
                DeinterlaceMode=DEINTERLACE_WEAVE if fmt.progressive_sequence else DEINTERLACE_ADAPTIVE,
                ulTargetWidth=fmt.coded_width, ulTargetHeight=fmt.coded_height, ulNumOutputSurfaces=2,
                vidLock=self._lock,
            )
            _check("cuvidCreateDecoder", self._cuvid.cuvidCreateDecoder(ctypes.byref(self._decoder),
                                                                       ctypes.byref(info)))
            self._format, self._surfaces = key, surfaces
            return surfaces
        except BaseException as e:  # noqa: BLE001  (stored; raised by feed once the parser returns)
            self._error = self._error or e
            return 0

    def _on_decode(self, _user, pic_params) -> int:
        try:
            if not self._decoder.value:
                raise CalibrationError("NVDEC: the parser asked for a picture before any sequence header")
            _check("cuvidDecodePicture", self._cuvid.cuvidDecodePicture(self._decoder, pic_params))
            _cuda_build.count_launch(NvdecDecoder, "launches")
            return 1
        except BaseException as e:  # noqa: BLE001
            self._error = self._error or e
            return 0

    def _on_display(self, _user, info_p) -> int:
        try:
            if not info_p:  # the end of the stream
                return 1
            info = info_p.contents
            index = int(info.timestamp)
            if self.wanted is not None and index not in self.wanted:
                return 1
            self.frames[index] = self._copy_out(info)
            return 1
        except BaseException as e:  # noqa: BLE001
            self._error = self._error or e
            return 0

    def _copy_out(self, info: CUVIDPARSERDISPINFO):
        """Map the shown picture, copy its visible NV12 planes into new
        tensors on torch's current stream, wait for the copy, unmap."""
        coded_w, coded_h, left, top, _, _ = self._format
        width, height = self.size
        stream = torch.cuda.current_stream(self.device)
        proc = CUVIDPROCPARAMS(progressive_frame=info.progressive_frame, second_field=info.repeat_first_field + 1,
                               top_field_first=info.top_field_first,
                               unpaired_field=int(info.repeat_first_field < 0), output_stream=stream.cuda_stream)
        ptr, pitch = c_ulonglong(), c_uint()
        _check("cuvidMapVideoFrame64", self._cuvid.cuvidMapVideoFrame64(
            self._decoder, info.picture_index, ctypes.byref(ptr), ctypes.byref(pitch), ctypes.byref(proc)))
        try:
            chroma_at = ptr.value + pitch.value * ((coded_h + 1) & ~1)
            luma = _DevicePlane(ptr.value + top * pitch.value + left, (height, width), pitch.value)
            chroma = _DevicePlane(chroma_at + (top // 2) * pitch.value + (left & ~1),
                                  ((height + 1) // 2, (width + 1) // 2, 2), pitch.value)
            with torch.cuda.device(self.device):
                y = torch.as_tensor(luma, device=self.device).clone()
                uv = torch.as_tensor(chroma, device=self.device).clone()
            stream.synchronize()
        finally:
            _check("cuvidUnmapVideoFrame64", self._cuvid.cuvidUnmapVideoFrame64(self._decoder, ptr.value))
        return y, uv

    # -- feeding -------------------------------------------------------------

    def _parse(self, payload: bytes, flags: int, timestamp: int = 0) -> None:
        buf = ctypes.create_string_buffer(payload, len(payload)) if payload else None
        packet = CUVIDSOURCEDATAPACKET(flags=flags, payload_size=len(payload),
                                       payload=ctypes.addressof(buf) if buf is not None else None,
                                       timestamp=timestamp)
        with _pushed(self._ctx):
            result = self._cuvid.cuvidParseVideoData(self._parser, ctypes.byref(packet))
        if self._error is not None:
            error, self._error = self._error, None
            raise error
        _check("cuvidParseVideoData", result)

    def feed(self, sample: bytes, index: int) -> None:
        """Parse one sample, which shows as frame `index`. Samples may be
        left out between calls as long as the next one fed decodes from
        what was fed before (a sync sample does)."""
        if self.codec == "h264":
            sample = annex_b(sample, self._nal_length_size)
        if not self._started:
            sample = self._extradata + sample  # the parameter sets / VOL header first
            self._started = True
        self._parse(sample, PKT_TIMESTAMP | PKT_ENDOFPICTURE, index)

    def end(self) -> None:
        """Flush: every picture still held is decoded and shown."""
        self._parse(b"", PKT_ENDOFSTREAM)

    def pop(self, index: int):
        return self.frames.pop(index, None)

    def close(self) -> None:
        if self._parser is None:
            return
        with _pushed(self._ctx):
            if self._parser.value:
                self._cuvid.cuvidDestroyVideoParser(self._parser)
            if self._decoder.value:
                self._cuvid.cuvidDestroyDecoder(self._decoder)
            if self._lock.value:
                self._cuvid.cuvidCtxLockDestroy(self._lock)
        self._parser = None
        self.frames.clear()


class _DevicePlane:
    """A pitched uint8 plane in device memory that torch.as_tensor can view
    (the CUDA array interface, version 2: no stream to synchronise with)."""

    def __init__(self, ptr: int, shape: tuple, pitch: int):
        strides = (pitch, 1) if len(shape) == 2 else (pitch, 2, 1)
        self.__cuda_array_interface__ = {"shape": shape, "typestr": "|u1", "data": (ptr, False),
                                         "strides": strides, "version": 2}
