"""Evaluation: the classic SyncNet scorer (AV offset and sync confidence),
its MFCC features and the face tracks it scores."""
