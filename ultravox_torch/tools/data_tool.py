"""Dataset browser (reference: tools/data_tool.py:1-71): print samples from a
registered dataset, optionally applying an augmentation, playing the audio
through the local sound device (``--play``, when sounddevice is installed)
and/or dumping it to WAV files.

CLI: ``python -m ultravox_torch.tools.data_tool --data_set synthetic-asr -n 3``
"""

from __future__ import annotations

import argparse
import os


def main():
    from ultravox_torch.data import registry, types
    from ultravox_torch.data.aug import create_augmentation
    from ultravox_torch.data.sample import audio_to_wav_bytes

    parser = argparse.ArgumentParser()
    parser.add_argument("--data_set", required=True)
    parser.add_argument("-n", "--num_samples", type=int, default=5)
    parser.add_argument("--split", default="train")
    parser.add_argument("--augmentation", default=None)
    parser.add_argument("--save_audio_dir", default=None)
    parser.add_argument("--no_audio", action="store_true")
    parser.add_argument(
        "-p", "--play", action="store_true",
        help="play each sample through the sound device (needs sounddevice)",
    )
    parser.add_argument(
        "-r", "--playback_rate", type=float, default=None,
        help="time-stretch factor for --play (>1 = faster)",
    )
    args = parser.parse_args()

    sd = None
    if args.play:
        # optional dependency (reference plays via sounddevice,
        # tools/data_tool.py:1-71); headless/CI environments fall back to
        # --save_audio_dir
        try:
            import sounddevice as sd  # type: ignore[no-redef]
        except ImportError:
            print(
                "[--play] sounddevice is not installed; "
                "use --save_audio_dir to dump WAVs instead"
            )

    ds_args = types.VoiceDatasetArgs(
        split=types.DatasetSplit(args.split),
        include_audio=not args.no_audio,
        max_audio_duration_secs=None,
        max_input_characters=None,
    )
    dataset = registry.create_dataset(args.data_set, ds_args)
    aug = create_augmentation(args.augmentation) if args.augmentation else None

    for i, sample in enumerate(dataset):
        if i >= args.num_samples:
            break
        if aug:
            sample = aug.apply_sample(sample)
        print(f"--- sample {i} ---")
        for m in sample.messages:
            print(f"[{m['role']}] {m['content']}")
        if sample.audio is not None:
            secs = len(sample.audio) / sample.sample_rate
            print(f"[audio] {secs:.2f}s @ {sample.sample_rate} Hz")
            if sd is not None:
                audio = sample.audio
                if args.playback_rate:
                    # simple rate change by resampling (the reference
                    # time-stretches via librosa; a pitch-shifting rate
                    # change is fine for browsing)
                    from ultravox_torch.utils.audio import resample

                    audio = resample(
                        audio, sample.sample_rate,
                        int(sample.sample_rate / args.playback_rate),
                    )
                sd.play(audio, sample.sample_rate)
                sd.wait()
            if args.save_audio_dir:
                os.makedirs(args.save_audio_dir, exist_ok=True)
                path = os.path.join(args.save_audio_dir, f"sample_{i}.wav")
                with open(path, "wb") as f:
                    f.write(audio_to_wav_bytes(sample.audio, sample.sample_rate))
                print(f"[audio saved] {path}")


if __name__ == "__main__":
    main()
